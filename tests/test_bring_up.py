"""The surfaces the GPU bring-up added: run_case without HDF5, the FDTD run
log, the procedural phantom at adult size, and the benchmarks' refusal to
run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_case_without_hdf5(tmp_path):
    """write_h5=False: no HDF5 file is written, the NIfTI mask and the
    in-memory DataForSim/thermal results are the same as with HDF5."""
    from babelbrain_tpu.pipeline.phantom import build_head
    from babelbrain_tpu.pipeline.profiles import (
        TRANSDUCER_REGISTRY,
        TransducerSpec,
    )
    from babelbrain_tpu.pipeline.runner import CaseConfig, run_case
    from babelbrain_tpu.pipeline.thermal import SonicationParams

    TRANSDUCER_REGISTRY["NoH5Test"] = TransducerSpec(
        "NoH5Test", "single", diameter=16e-3, focal_length=20e-3,
        frequencies=(500e3,),
    )
    labels, ct, _, _, _, aff = build_head(n=48, voxel_mm=3.0,
                                          skull_radius_mm=55.0)
    kw = dict(target_ras=[0.0, 0.0, 30.0], direction_ras=[0, 0, -1],
              mask_shape=(28, 28, 52),
              thermal_params=SonicationParams(duration_on=0.05,
                                              duration_off=0.05))
    out = {}
    for h5 in (True, False):
        cfg = CaseConfig(tx_system="NoH5Test", ppw=3.0,
                         output_dir=str(tmp_path / str(h5)), prefix="c")
        out[h5] = run_case(cfg, labels, aff, write_h5=h5, **kw)
    files = os.listdir(tmp_path / "False")
    assert not [f for f in files if f.endswith(".h5")], files
    assert os.path.isfile(out[False]["files"]["mask"])
    assert out[False]["files"]["acoustic"] is None
    assert out[False]["files"]["thermal"] is None
    assert os.path.isfile(out[True]["files"]["acoustic"])
    np.testing.assert_array_equal(out[False]["data_for_sim"]["p_amp"],
                                  out[True]["data_for_sim"]["p_amp"])
    np.testing.assert_array_equal(out[False]["thermal"].dose,
                                  out[True]["thermal"].dose)


def test_fdtd_run_log_records_compile_once():
    from babelbrain_tpu.ops.fdtd import (
        FDTDGrid,
        fdtd_executable_stats,
        fdtd_run_log,
        run_fdtd,
        stable_dt,
    )

    dx = 1500.0 / 500e3 / 6
    dt = stable_dt(dx, 1500.0, 0.5)
    grid = FDTDGrid(shape=(16, 18, 24), dx=dx, dt=dt, n_steps=12,
                    frequency=500e3, npml=4, sensor_start=6,
                    source_plane_z=5)
    mats = np.array([[1000.0, 1500.0, 0.0, 1.0, 0.0]])
    amp = np.zeros((16, 18), np.float32)
    amp[5:-5, 5:-5] = 1e4
    fdtd_run_log(reset=True)
    fdtd_executable_stats(reset=True)
    for s in (1.0, 2.0):
        run_fdtd(np.zeros(grid.shape, np.uint8), mats, grid,
                 source_amp=amp * s)
    log = fdtd_run_log(reset=True)
    assert [r["shape"] for r in log] == [(16, 18, 24)] * 2
    assert log[0]["compile_s"] > 0 and log[1]["compile_s"] == 0.0
    assert all(r["run_s"] > 0 and r["platform"] == "cpu" and not r["shear"]
               and r["n_steps"] == 12 and r["cases"] == 1 for r in log)
    assert fdtd_executable_stats() == {"builds": 1, "hits": 1}
    assert fdtd_run_log() == []


@pytest.mark.parametrize("radius,n,vox", [(60.0, 96, 2.0), (85.0, 100, 2.0)])
def test_phantom_skull_at_requested_radius(radius, n, vox):
    """The outer skull sits at the requested radius along the z axis, under
    a 5 mm scalp, with brain inside and water outside."""
    from babelbrain_tpu.pipeline.phantom import build_head

    labels, ct, zte, petra, dens, aff = build_head(
        n=n, voxel_mm=vox, skull_radius_mm=radius)
    assert labels.shape == ct.shape == (n, n, n)
    col = labels[n // 2, n // 2]  # the +z/-z axis through the centre
    z = np.arange(n) * vox - n * vox / 2
    bone_z = z[(col == 7) & (z > 0)]
    skin_z = z[(col == 5) & (z > 0)]
    assert abs(bone_z.max() - radius) <= 0.05 * radius + vox
    assert skin_z.min() > bone_z.max() and skin_z.max() <= bone_z.max() + 5 + vox
    assert col[n // 2] in (1, 2)  # brain at the centre
    assert col[0] == 0 and ct[n // 2, n // 2, 0] == 20.0  # water bath
    assert np.allclose(aff[:3, 3], -n * vox / 2)


@pytest.mark.parametrize("script", ["bench.py", "bench_suite.py"])
def test_benchmarks_refuse_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert '"metric"' not in r.stdout
