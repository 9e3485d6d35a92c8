"""Golden-field regression tier (the reference's tol_0/tol_1/tol_5 scheme,
`pytest.ini:44-61` of the reference).

Three canonical solver configurations are compared against stored golden
amplitude fields within tolerance tiers. Regenerate goldens (after an
intentional numerics change) with:

    BBT_GENERATE_GOLDEN=1 python -m pytest tests/test_regression.py

Goldens are generated on the CPU mesh (deterministic across runs there);
comparisons use relative L2 and peak-relative Linf.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from babelbrain_tpu.ops.fdtd import FDTDGrid, run_fdtd, stable_dt

GOLDEN_DIR = Path(__file__).parent / "golden"
GENERATE = os.environ.get("BBT_GENERATE_GOLDEN") == "1"

F0 = 500e3


def _run_config(name):
    if name == "water_plane":
        shape = (40, 40, 150)
        dx = 1500.0 / F0 / 9
        ppp = int(np.ceil(1 / F0 / stable_dt(dx, 1500.0, 0.9)))
        mats = np.array([[1000.0, 1500.0, 0, 0, 0]])
        idx = np.zeros(shape, np.uint8)
        amp = np.full(shape[:2], 60e3)
        ph = np.zeros(shape[:2])
    elif name == "skull_slab_visco":
        shape = (64, 48, 120)
        dx = 1102.5 / F0 / 6
        ppp = int(np.ceil(1 / F0 / stable_dt(dx, 2494.0, 0.5)))
        mats = np.array(
            [
                [1000.0, 1500.0, 0, 0, 0],
                [1116.0, 1537.0, 0, 2.3, 0],
                [1896.5, 2494.0, 1594.0, 106.0, 214.0],
                [1738.0, 2247.0, 1345.0, 105.0, 214.0],
                [1041.0, 1562.0, 0, 3.45, 0],
            ]
        )
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 44:48] = 1
        idx[:, :, 48:51] = 2
        idx[:, :, 51:56] = 3
        idx[:, :, 56:59] = 2
        idx[:, :, 59:] = 4
        rng = np.random.default_rng(42)
        amp = np.zeros(shape[:2])
        amp[16:-16, 16:-16] = 60e3 * rng.uniform(0.8, 1.0, (32, 16))
        ph = rng.uniform(-0.5, 0.5, shape[:2])
    elif name == "ct_slab_fluid":
        shape = (64, 48, 120)
        dx = 1482.3 / F0 / 6
        ppp = int(np.ceil(1 / F0 / stable_dt(dx, 2900.0, 0.5)))
        hu = np.linspace(400, 2000, 20)
        from babelbrain_tpu.materials import map_hu_to_properties

        rho, sos, att = map_hu_to_properties(hu, F0, "Webb-Marsac")
        mats = np.zeros((23, 5))
        mats[0] = [1000.0, 1500.0, 0, 0, 0]
        mats[1] = [1116.0, 1537.0, 0, 2.99, 0]
        mats[2] = [1041.0, 1562.0, 0, 4.49, 0]
        mats[3:, 0] = rho
        mats[3:, 1] = sos
        mats[3:, 3] = att
        rng = np.random.default_rng(7)
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 44:48] = 1
        idx[:, :, 48:60] = rng.integers(3, 23, (64, 48, 12))
        idx[:, :, 60:] = 2
        amp = np.zeros(shape[:2])
        amp[16:-16, 16:-16] = 60e3
        ph = np.zeros(shape[:2])
    else:
        raise KeyError(name)

    dt = 1 / F0 / ppp
    nsteps = ppp * 18
    grid = FDTDGrid(
        shape=shape, dx=dx, dt=dt, n_steps=nsteps, frequency=F0,
        sensor_start=nsteps - 2 * ppp, source_plane_z=13,
    )
    out = run_fdtd(idx, mats, grid, source_amp=amp, source_phase=ph)
    return out["p_amp"].astype(np.float32)


# (name, rel-L2 bound, peak-relative L-inf bound)
GOLDENS = [
    ("water_plane", 0.01, 0.01),
    ("skull_slab_visco", 0.01, 0.02),
    ("ct_slab_fluid", 0.01, 0.02),
]


def golden_errors(name, field):
    """(rel-L2, peak-relative L-inf) of ``field`` against the golden."""
    gold = np.load(GOLDEN_DIR / f"{name}.npz")["p_amp_kpa"].astype(
        np.float32) * 1e3
    l2 = np.linalg.norm(field - gold) / np.linalg.norm(gold)
    linf = np.abs(field - gold).max() / gold.max()
    return float(l2), float(linf)


@pytest.mark.parametrize("name,tol_l2,tol_linf", GOLDENS)
@pytest.mark.tol_1
def test_golden_field(name, tol_l2, tol_linf):
    path = GOLDEN_DIR / f"{name}.npz"
    field = _run_config(name)
    if GENERATE or not path.exists():
        GOLDEN_DIR.mkdir(exist_ok=True)
        np.savez_compressed(path, p_amp_kpa=(field / 1e3).astype(np.float16))
        pytest.skip(f"golden generated: {path.name}")
    l2, linf = golden_errors(name, field)
    assert l2 < tol_l2, f"{name}: L2 {l2:.4f}"
    assert linf < tol_linf, f"{name}: Linf {linf:.4f}"
