"""External anchor for the through-skull SHEAR path (VERDICT r4 task 4).

The reference's correctness story for through-skull propagation is
hydrophone validation and the multi-solver inter-comparison
(`/root/reference/README.md:27`), both covering shear/mode conversion.
Offline, the computable external truth is the exact plane-wave solution
for an elastic layer immersed in fluid with P<->SV mode conversion
(`pipeline.benchmark.solid_layer_transmission`, a 6x6 displacement-
potential boundary-value problem; Brekhovskikh, *Waves in Layered
Media*). This tier anchors the viscoelastic solver against it:

* normal incidence (longitudinal-only physics) to ~2% measured,
  asserted at the 5% tier, at thicknesses AWAY from the transparency
  resonance (at kL*d ~ pi the analytic |T| moves >30% per half-cell of
  thickness, so d=8 cells is excluded by design — the documented
  discretization term);
* oblique incidence through a TILTED slab driven by the validated
  normal-incidence plane-wave apparatus (tilting the slab instead of
  the beam keeps the source clean and walks the specular reflection
  off-axis instead of pumping the source-plane cavity). At 25 deg the
  elastic slab transmits via strong P->SV conversion: the analytic
  elastic |T| = 0.98 vs 0.48 for the same slab WITHOUT shear — a +106%
  discrimination — and the simulation must match the ELASTIC value at
  the 5% tier while a zero-shear control slab must track the no-shear
  value. Staircase discretization of the tilted interfaces at 9 PPW is
  the residual error term (45-deg tilts go staircase-unstable in this
  elastic contrast and are excluded; the instability is the staggered-
  grid jagged-interface mode documented in the FDTD literature, not a
  solver regression — flat and 25-deg interfaces are asserted stable
  here).
"""

import numpy as np
import pytest

from babelbrain_tpu.ops.fdtd import FDTDGrid, run_fdtd, stable_dt
from babelbrain_tpu.pipeline.benchmark import solid_layer_transmission

F0, C = 500e3, 1500.0
FLUID = (1000.0, C)
SOLID = (1896.5, 2494.0, 1400.0)
DX = C / F0 / 9
PPP = int(np.ceil(1 / F0 / stable_dt(DX, SOLID[1], cfl=0.5)))
DT = 1 / F0 / PPP
SHAPE = (32, 224, 144)


class TestAnalyticLayer:
    """Self-checks of the analytic truth (offline-verifiable)."""

    def test_energy_conservation(self):
        for th in np.deg2rad([0, 10, 25, 40, 60]):
            T, R = solid_layer_transmission(th, F0, 2.6e-3, FLUID, SOLID)
            assert abs(abs(R) ** 2 + abs(T) ** 2 - 1.0) < 1e-9

    def test_reduces_to_classic_normal_incidence(self):
        d = 2.6e-3
        rho1, c1 = FLUID
        rho, cL, _ = SOLID
        Z1, ZL = rho1 * c1, rho * cL
        kLd = 2 * np.pi * F0 / cL * d
        classic = 1.0 / np.sqrt(
            1 + 0.25 * (ZL / Z1 - Z1 / ZL) ** 2 * np.sin(kLd) ** 2
        )
        T, _ = solid_layer_transmission(0.0, F0, d, FLUID, SOLID)
        assert abs(abs(T) - classic) < 1e-12

    def test_transparent_at_zero_thickness(self):
        T, R = solid_layer_transmission(0.4, F0, 0.0, FLUID, SOLID)
        assert abs(abs(T) - 1.0) < 1e-9 and abs(R) < 1e-9

    def test_mode_conversion_discriminates(self):
        """At 25 deg the shear branch changes |T| by +106% — the basis
        for the FDTD discrimination assertion below."""
        th = np.deg2rad(25.0)
        Te = abs(solid_layer_transmission(th, F0, 6 * DX, FLUID, SOLID)[0])
        Tf = abs(
            solid_layer_transmission(
                th, F0, 6 * DX, FLUID, (SOLID[0], SOLID[1], 1e-6)
            )[0]
        )
        assert Te > 0.9 and Tf < 0.55


def _run_normal(d_cells, mats, ncyc=16):
    ns = ncyc * PPP
    idx = np.zeros(SHAPE, np.uint8)
    if d_cells:
        idx[:, :, 50:50 + d_cells] = 1
    grid = FDTDGrid(shape=SHAPE, dx=DX, dt=DT, n_steps=ns, frequency=F0,
                    sensor_start=ns - 2 * PPP, source_plane_z=13)
    jj = np.arange(SHAPE[1])
    env = np.exp(-((jj - 60.0) / 40.0) ** 8)
    amp = np.zeros(SHAPE[:2], np.float32)
    amp[:] = (60e3 * env)[None, :]
    amp[:12] = 0
    amp[-12:] = 0
    o = run_fdtd(idx, mats, grid, source_amp=amp,
                 source_phase=np.zeros(SHAPE[:2], np.float32))
    return o["p_amp"]


ALPHA_W = 10.0


def _run_tilted(theta_deg, d_cells, mats, ncyc=30):
    ns = ncyc * PPP
    th = np.deg2rad(theta_deg)
    idx = np.zeros(SHAPE, np.uint8)
    if d_cells:
        jj, kk = np.mgrid[0:SHAPE[1], 0:SHAPE[2]]
        s = -np.sin(th) * (jj - 112.0) + np.cos(th) * (kk - 62.0)
        idx[:, (s >= 0) & (s < d_cells)] = 1
    grid = FDTDGrid(shape=SHAPE, dx=DX, dt=DT, n_steps=ns, frequency=F0,
                    sensor_start=ns - 2 * PPP, source_plane_z=13)
    jj1 = np.arange(SHAPE[1])
    env = np.exp(-((jj1 - 112.0) / 55.0) ** 8)
    amp = np.zeros(SHAPE[:2], np.float32)
    amp[:] = (60e3 * env)[None, :]
    amp[:12] = 0
    amp[-12:] = 0
    o = run_fdtd(idx, mats, grid, source_amp=amp,
                 source_phase=np.zeros(SHAPE[:2], np.float32))
    return o["p_amp"]


@pytest.mark.slow
class TestShearAnchor:
    def test_normal_incidence_tol5(self):
        """Longitudinal-only anchor: d=6 and d=10 cell slabs, both away
        from the transparency resonance; measured +2.3% / +0.4%."""
        mats = np.array([[1000.0, C, 0.0, 0.0, 0.0],
                         [SOLID[0], SOLID[1], SOLID[2], 0.0, 0.0]])
        pw = _run_normal(0, mats[:1])
        for d in (6, 10):
            ps = _run_normal(d, mats)
            T_sim = ps[16, :, 90].max() / pw[16, :, 90].max()
            T_an = abs(
                solid_layer_transmission(0.0, F0, d * DX, FLUID, SOLID)[0]
            )
            assert abs(T_sim - T_an) / T_an < 0.05, (d, T_sim, T_an)

    def test_oblique_shear_conversion_tol5(self):
        """25-deg incidence through the tilted elastic slab: the
        transmitted amplitude is shear-conversion-dominated (elastic
        0.98 vs no-shear 0.48 analytic) and must match the ELASTIC
        analytic at the 5% tier. A zero-shear control slab in the same
        apparatus must land near the no-shear analytic and far from the
        elastic one — proving the apparatus discriminates the shear
        physics rather than flattering it."""
        th = np.deg2rad(25.0)
        mats_e = np.array([[1000.0, C, 0.0, ALPHA_W, 0.0],
                           [SOLID[0], SOLID[1], SOLID[2], 0.0, 0.0]])
        mats_f = np.array([[1000.0, C, 0.0, ALPHA_W, 0.0],
                           [SOLID[0], SOLID[1], 0.0, 0.0, 0.0]])
        pw = _run_tilted(25.0, 0, mats_e[:1])
        corr = np.exp(-ALPHA_W * 6 * DX / np.cos(th))

        ps = _run_tilted(25.0, 6, mats_e)
        T_sim = ps[16, 30:-30, 112].max() / pw[16, 30:-30, 112].max()
        T_sim *= corr
        T_an = abs(
            solid_layer_transmission(th, F0, 6 * DX, FLUID, SOLID)[0]
        )
        assert abs(T_sim - T_an) / T_an < 0.05, (T_sim, T_an)

        pf = _run_tilted(25.0, 6, mats_f)
        T_ctl = pf[16, 30:-30, 112].max() / pw[16, 30:-30, 112].max()
        T_ctl *= corr
        T_no = abs(
            solid_layer_transmission(
                th, F0, 6 * DX, FLUID, (SOLID[0], SOLID[1], 1e-6)
            )[0]
        )
        # control tracks the no-shear analytic and is FAR from elastic
        assert abs(T_ctl - T_no) / T_no < 0.20, (T_ctl, T_no)
        assert T_ctl < 0.75 * T_an, (T_ctl, T_an)
