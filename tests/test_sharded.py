"""Domain-decomposition correctness: sharded runs must match single-device.

The reference has no distributed execution (SURVEY.md section 2.8); this test
tier is new to this framework: bit-parity of the ppermute halo-exchange
path against the single-device stencil, through a viscoelastic shear slab so
every derivative/psi path is exercised.
"""

import numpy as np
import pytest

from babelbrain_tpu.ops.fdtd import FDTDGrid, run_fdtd, stable_dt
from babelbrain_tpu.parallel.halo import make_mesh, make_mesh_2d

F0, C = 500e3, 1500.0


def _grid(shape, n_cycles, npml=12):
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / stable_dt(dx, 2494.0, cfl=0.9)))
    dt = 1 / F0 / ppp
    nsteps = ppp * n_cycles
    return FDTDGrid(
        shape=shape, dx=dx, dt=dt, n_steps=nsteps, frequency=F0, npml=npml,
        sensor_start=nsteps - 2 * ppp, source_plane_z=npml + 1,
    )


@pytest.fixture(scope="module")
def case():
    shape = (128, 48, 80)
    grid = _grid(shape, 8)
    mats = np.array(
        [[1000.0, C, 0, 0, 0], [1896.5, 2494.0, 1594.0, 106.0, 214.0]]
    )
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 40:50] = 1
    rng = np.random.default_rng(0)
    amp = np.zeros(shape[:2])
    amp[16:-16, 16:-16] = 60e3 * rng.uniform(0.5, 1, (96, 16))
    ph = rng.uniform(-3, 3, shape[:2])
    return grid, mats, idx, amp, ph


class TestShardedParity:
    def test_8_shard_bit_parity(self, case):
        grid, mats, idx, amp, ph = case
        o1 = run_fdtd(idx, mats, grid, source_amp=amp, source_phase=ph)
        o8 = run_fdtd(
            idx, mats, grid, source_amp=amp, source_phase=ph, mesh=make_mesh(8)
        )
        assert np.isfinite(o1["p_amp"]).all()
        np.testing.assert_array_equal(o1["p_amp"], o8["p_amp"])
        np.testing.assert_array_equal(o1["peak"], o8["peak"])

    def test_2_shard_bit_parity(self, case):
        grid, mats, idx, amp, ph = case
        o1 = run_fdtd(idx, mats, grid, source_amp=amp, source_phase=ph)
        o2 = run_fdtd(
            idx, mats, grid, source_amp=amp, source_phase=ph, mesh=make_mesh(2)
        )
        np.testing.assert_array_equal(o1["p_amp"], o2["p_amp"])

    def test_2d_mesh_bit_parity(self, case):
        """2-D (x, y) plane decomposition: viscoelastic shear slab through
        a 4x2 mesh exercises every y-ghost/y-CPML-mask path."""
        grid, mats, idx, amp, ph = case
        o1 = run_fdtd(idx, mats, grid, source_amp=amp, source_phase=ph)
        o8 = run_fdtd(
            idx, mats, grid, source_amp=amp, source_phase=ph,
            mesh=make_mesh_2d(4, 2),
        )
        np.testing.assert_array_equal(o1["p_amp"], o8["p_amp"])
        np.testing.assert_array_equal(o1["peak"], o8["peak"])

    def test_2d_mesh_fluid_parity(self):
        """Fluid (CT-mode) path on a 2x4 mesh with dominant y-sharding."""
        shape = (64, 64, 48)
        grid = _grid(shape, 4)
        mats = np.array([[1000.0, C, 0.0, 2.0, 0.0]])
        idx = np.zeros(shape, np.uint8)
        rng = np.random.default_rng(1)
        amp = np.zeros(shape[:2])
        amp[16:-16, 16:-16] = 60e3 * rng.uniform(0.5, 1, (32, 32))
        ph = rng.uniform(-3, 3, shape[:2])
        o1 = run_fdtd(idx, mats, grid, source_amp=amp, source_phase=ph)
        o8 = run_fdtd(
            idx, mats, grid, source_amp=amp, source_phase=ph,
            mesh=make_mesh_2d(2, 4),
        )
        np.testing.assert_array_equal(o1["p_amp"], o8["p_amp"])

    def test_2d_point_source_on_inner_shard(self):
        """stress_point source owned by an interior (x, y) shard."""
        shape = (64, 64, 48)
        grid0 = _grid(shape, 6, npml=4)
        grid = FDTDGrid(
            shape=shape, dx=grid0.dx, dt=grid0.dt, n_steps=grid0.n_steps,
            frequency=F0, npml=4, sensor_start=grid0.sensor_start,
            source_plane_z=5, source_type="stress_point",
            source_ijk=(33, 37, 24),
        )
        mats = np.array([[1000.0, C, 0, 0, 0]])
        idx = np.zeros(shape, np.uint8)
        o1 = run_fdtd(idx, mats, grid, point_amp=60e3)
        o8 = run_fdtd(idx, mats, grid, point_amp=60e3, mesh=make_mesh_2d(2, 4))
        assert o1["p_amp"].max() > 0
        np.testing.assert_allclose(
            o1["p_amp"], o8["p_amp"], rtol=1e-4, atol=o1["p_amp"].max() * 1e-5
        )

    def test_2d_mesh_constraints_raise(self, case):
        grid, mats, idx, amp, ph = case
        # N2=48 not divisible by 5... use a y size that doesn't divide: 4x2
        # is fine, but y-local 48/2=24 >= 14; force thin shards via 1x8
        with pytest.raises(ValueError):
            run_fdtd(
                idx, mats, grid, source_amp=amp, source_phase=ph,
                mesh=make_mesh_2d(1, 8),
            )

    @pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
    def test_volume_source_parity(self, mesh_shape):
        """Dome volumetric drive (``velocity_volume``) in zero-shear media:
        the per-voxel velocity injection sharded over an x or an (x, y)
        mesh must match the single-device scan. Unphased drive, so the
        injection has no dot whose contraction could differ between
        graphs: bit-exact."""
        shape = (64, 32, 48)
        grid0 = _grid(shape, 3, npml=6)
        grid = FDTDGrid(
            shape=shape, dx=grid0.dx, dt=grid0.dt, n_steps=grid0.n_steps,
            frequency=F0, npml=6, sensor_start=grid0.sensor_start,
            source_type="velocity_volume",
        )
        mats = np.array(
            [[1000.0, C, 0.0, 20.0, 0.0], [1896.0, 2494.0, 0.0, 150.0, 0.0]]
        )
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 28:34] = 1
        ii, jj, kk = np.mgrid[0:64, 0:32, 0:48]
        r = np.sqrt((ii - 32.0) ** 2 + (jj - 16.0) ** 2 + (kk - 20.0) ** 2)
        shell = (r > 9) & (r < 11) & (kk < 20)
        rr = np.maximum(r, 1e-6)
        vs = dict(
            amp=np.where(shell, 60e3, 0.0).astype(np.float32),
            phase=np.zeros(shape, np.float32),
            ox=((32.0 - ii) / rr).astype(np.float32),
            oy=((16.0 - jj) / rr).astype(np.float32),
            oz=((20.0 - kk) / rr).astype(np.float32),
        )
        mesh = (make_mesh(mesh_shape[0]) if mesh_shape[1] == 1
                else make_mesh_2d(*mesh_shape))
        o1 = run_fdtd(idx, mats, grid, volume_source=vs)
        o4 = run_fdtd(idx, mats, grid, volume_source=vs, mesh=mesh)
        assert o1["p_amp"].max() > 0
        np.testing.assert_array_equal(o4["p_amp"], o1["p_amp"])
        np.testing.assert_array_equal(o4["peak"], o1["peak"])

    def test_point_source_on_nonzero_shard(self):
        # stress point source owned by a middle shard, sharded 4 ways
        shape = (64, 32, 48)
        grid0 = _grid(shape, 6, npml=4)
        grid = FDTDGrid(
            shape=shape, dx=grid0.dx, dt=grid0.dt, n_steps=grid0.n_steps,
            frequency=F0, npml=4, sensor_start=grid0.sensor_start,
            source_plane_z=5, source_type="stress_point", source_ijk=(33, 16, 24),
        )
        mats = np.array([[1000.0, C, 0, 0, 0]])
        idx = np.zeros(shape, np.uint8)
        o1 = run_fdtd(idx, mats, grid, point_amp=60e3)
        o4 = run_fdtd(idx, mats, grid, point_amp=60e3, mesh=make_mesh(4))
        assert o1["p_amp"].max() > 0
        # the masked scatter-add compiles to a different fusion order, so
        # allow f32 rounding-level differences (plane-source paths above are
        # bit-exact)
        np.testing.assert_allclose(
            o1["p_amp"], o4["p_amp"], rtol=1e-4, atol=o1["p_amp"].max() * 1e-5
        )

    def test_shard_constraints_raise(self, case):
        grid, mats, idx, amp, ph = case
        bad = FDTDGrid(
            shape=(126, 48, 80), dx=grid.dx, dt=grid.dt, n_steps=4,
            frequency=F0, source_plane_z=13,
        )
        with pytest.raises(ValueError):
            run_fdtd(
                np.zeros((126, 48, 80), np.uint8), mats, bad,
                source_amp=np.zeros((126, 48)), mesh=make_mesh(8),
            )


def _import_graft_entry():
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    return importlib.import_module("__graft_entry__")


class TestGraftEntry:
    def test_entry_compiles(self):

        import jax

        ge = _import_graft_entry()
        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert all(np.isfinite(np.asarray(o)).all() for o in out)

    def test_dryrun_multichip(self):
        _import_graft_entry().dryrun_multichip(8)


class TestShardedExtras:
    def test_sel_maps_and_monitor_match_single_device(self):
        """SelMapsRMSPeakList maps + SensorOutput monitor series under
        domain decomposition must equal the single-device values (maps
        shard like the volume; the monitor gather psums ownership)."""
        shape = (64, 32, 48)
        grid = _grid(shape, 3, npml=12)
        mats = np.array([[1000.0, C, 0.0, 20.0, 0.0]])
        idx = np.zeros(shape, np.uint8)
        amp = np.zeros(shape[:2], np.float32)
        amp[10:-10, 10:22] = 60e3
        mon = np.array([[13, 15, 30], [40, 16, 36], [60, 20, 26]])
        kw = dict(
            source_amp=amp,
            sel_maps=("Pressure_rms", "Vz_peak"),
            monitor_ijk=mon,
            sensor_subsampling=2,
        )
        o1 = run_fdtd(idx, mats, grid, **kw)
        o4 = run_fdtd(idx, mats, grid, mesh=make_mesh(4), **kw)
        np.testing.assert_array_equal(o4["Pressure_rms"], o1["Pressure_rms"])
        np.testing.assert_array_equal(o4["Vz_peak"], o1["Vz_peak"])
        np.testing.assert_array_equal(o4["sensor_series"],
                                      o1["sensor_series"])
        np.testing.assert_array_equal(o4["sensor_times"], o1["sensor_times"])

    @pytest.mark.slow
    def test_sharded_with_reflector_bit_parity(self):
        """The production multi-device CT case: air-cavity reflector folded
        into the moduli. Sharded must stay bit-exact vs the single-device
        run."""
        shape = (128, 32, 48)
        grid = _grid(shape, 3, npml=12)
        mats = np.array([[1000.0, C, 0.0, 20.0, 0.0]])
        idx = np.zeros(shape, np.uint8)
        amp = np.zeros(shape[:2], np.float32)
        amp[10:-10, 10:22] = 60e3
        refl = np.zeros(shape, bool)
        refl[40:90, 8:24, 30:34] = True
        kw = dict(source_amp=amp, reflector_mask=refl)
        o1 = run_fdtd(idx, mats, grid, **kw)
        o4 = run_fdtd(idx, mats, grid, mesh=make_mesh(4), **kw)
        assert o1["p_amp"].max() > 0
        np.testing.assert_array_equal(o4["p_amp"], o1["p_amp"])
        np.testing.assert_array_equal(o4["peak"], o1["peak"])
        assert o4["p_amp"][refl].max() == 0.0
