#!/usr/bin/env python
"""Per-solver throughput on one NVIDIA GPU: one JSON line per cell.

  * fdtd_fluid_ct     — CT mode (1026 quantized-HU materials, no shear),
                        192x192x240, 42 cycles with the DFT over the last 2.
  * fdtd_visco_label  — label mode (5 tissues incl. skull shear), the
                        15-field viscoelastic update, same grid.
  * fdtd_visco_narrow — label mode on a tight-narrow-beam 192x128x192 grid.
  * fdtd_dome         — volumetric (dome) drive in a fluid, 192^3.
  * rayleigh          — Rayleigh-Sommerfeld pair throughput.
  * bhte              — Pennes bio-heat FTCS scan, 192^3.

Every cell goes through the production entry points (``run_fdtd``'s
compiled XLA scan, ``_bhte_scan``, the blocked Rayleigh evaluation). Times
end in ``jax.block_until_ready`` and exclude compilation; each cell runs
once to compile and then ``REPEATS`` times, reporting the best and the
spread. The script fails unless JAX's first device is a GPU, and prints the
card's name and power limit first. Usage:
``python bench_suite.py [cell ...]``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _ROOT)

from babelbrain_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

SHAPE = (192, 192, 240)
F0 = 500e3
PPW = 6.0
REPEATS = 3


def device_info():
    """JAX's device description; exits unless the first device is a GPU."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"bench needs a GPU; JAX reports platform {d.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def _emit(metric, values, unit):
    print(json.dumps({
        "metric": metric, "value": max(values), "unit": unit,
        "runs": values, "device": _DEVICE,
    }), flush=True)


def _fdtd_cell(metric, idx, mats, shape, source_type="velocity_plane",
               volume_source=None):
    from babelbrain_tpu.ops.fdtd import (
        FDTDGrid,
        fdtd_run_log,
        run_fdtd,
        stable_dt,
    )

    cmax = mats[:, 1:3].max()
    dx = 1482.3 / F0 / PPW
    ppp = int(np.ceil(1 / F0 / stable_dt(dx, cmax, cfl=0.5)))
    dt = 1 / F0 / ppp
    n_steps = 42 * ppp
    grid = FDTDGrid(
        shape=shape, dx=dx, dt=dt, n_steps=n_steps, frequency=F0,
        sensor_start=n_steps - 2 * ppp, source_plane_z=13,
        source_type=source_type,
    )
    amp = np.zeros(shape[:2], np.float32)
    amp[16:-16, 16:-16] = 60e3
    fdtd_run_log(reset=True)
    for _ in range(REPEATS + 1):
        run_fdtd(idx, mats, grid, source_amp=amp, volume_source=volume_source)
    runs = fdtd_run_log(reset=True)[1:]
    rates = [np.prod(shape) * n_steps / r["run_s"] / 1e9 for r in runs]
    _emit(metric, rates, "Gcell-updates/s")


def _label_slab(shape):
    idx = np.zeros(shape, np.uint16)
    idx[:, :, 60:70] = 3        # skin
    idx[:, :, 70:78] = 1        # cortical (shear)
    idx[:, :, 78:84] = 2        # trabecular (shear)
    idx[:, :, 84:88] = 1
    idx[:, :, 88:] = 4          # brain
    return idx


def bench_fluid_ct():
    from babelbrain_tpu.materials import map_hu_to_properties

    hu = np.linspace(300.0, 2100.0, 1023)
    rho, sos, att = map_hu_to_properties(hu, F0, "Webb-Marsac")
    mats = np.zeros((1026, 5))
    mats[0] = [1000.0, 1500.0, 0, 0, 0]
    mats[1] = [1116.0, 1537.0, 0, 2.99, 0]
    mats[2] = [1041.0, 1562.0, 0, 4.49, 0]
    mats[3:, 0] = rho
    mats[3:, 1] = sos
    mats[3:, 3] = att
    idx = np.zeros(SHAPE, np.uint16)
    rng = np.random.default_rng(0)
    idx[:, :, 60:70] = 1
    idx[:, :, 70:88] = rng.integers(3, 1026, (192, 192, 18))
    idx[:, :, 88:] = 2
    _fdtd_cell("fdtd_fluid_ct", idx, mats, SHAPE)


def bench_visco_label():
    from babelbrain_tpu.materials import material_array

    # water/cortical/trabecular/skin/brain order
    _fdtd_cell("fdtd_visco_label", _label_slab(SHAPE), material_array(F0),
               SHAPE)


def bench_visco_narrow():
    from babelbrain_tpu.materials import material_array

    shape = (192, 128, 192)
    _fdtd_cell("fdtd_visco_narrow", _label_slab(shape), material_array(F0),
               shape)


def bench_dome():
    shape = (192, 192, 192)
    mats = np.array([[1000.0, 1500.0, 0.0, 4.0, 0.0]])
    # hemispheric shell of velocity sources around the centre
    ii, jj, kk = np.ogrid[0:shape[0], 0:shape[1], 0:shape[2]]
    c = np.array(shape) / 2.0
    r = np.sqrt((ii - c[0]) ** 2 + (jj - c[1]) ** 2 + (kk - c[2]) ** 2)
    shell = (np.abs(r - 80.0) < 1.0) & (kk < c[2])
    vs = {
        "amp": np.where(shell, 60e3, 0.0).astype(np.float32),
        "phase": np.zeros(shape, np.float32),
        "ox": np.broadcast_to((c[0] - ii) / (r + 1e-6), shape),
        "oy": np.broadcast_to((c[1] - jj) / (r + 1e-6), shape),
        "oz": np.broadcast_to((c[2] - kk) / (r + 1e-6), shape),
    }
    _fdtd_cell("fdtd_dome", np.zeros(shape, np.uint16), mats, shape,
               source_type="velocity_volume", volume_source=vs)


def bench_rayleigh():
    import jax
    import jax.numpy as jnp

    from babelbrain_tpu.ops.rayleigh import _rayleigh_blocks

    M, P = 16384, 1_048_576
    rng = np.random.default_rng(1)
    centers = rng.normal(0, 0.03, (M, 3)).astype(np.float32)
    centers[:, 2] -= 0.08
    w = np.exp(1j * rng.uniform(0, 2 * np.pi, M)) * 1e-7
    kr = 2 * np.pi * F0 / 1482.3
    args = (kr, 0.0, jnp.asarray(centers),
            jnp.asarray(np.real(w), jnp.float32),
            jnp.asarray(np.imag(w), jnp.float32),
            jnp.asarray(rng.normal(0, 0.04, (P, 3)).astype(np.float32)),
            8192, 2048)
    jax.block_until_ready(_rayleigh_blocks(*args))
    rates = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(_rayleigh_blocks(*args))
        rates.append(M * P / (time.perf_counter() - t0) / 1e9)
    _emit("rayleigh", rates, "Gpairs/s")


def bench_bhte():
    import jax
    import jax.numpy as jnp

    from babelbrain_tpu.materials import (
        build_thermal_material_list,
        material_array,
    )
    from babelbrain_tpu.ops import bhte as B

    shape = (192, 192, 192)
    acoustic = material_array(
        F0, tissues=("Water", "Skin", "Cortical", "Trabecular", "Brain")
    )
    mats = build_thermal_material_list(
        acoustic, ct_mode=False, segmented_brain=False
    )
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 60:70] = 1   # skin
    idx[:, :, 70:88] = 2   # cortical
    idx[:, :, 88:] = 4     # brain
    p = np.zeros(shape, np.float32)
    p[80:110, 80:110, 110:150] = 1e6
    dt, dx = 0.01, 1482.3 / F0 / PPW
    n = 500
    Q = np.stack([B.absorption_heating(p, idx, mats, 0.3),
                  np.zeros(shape, np.float32)])
    coeff = {k: jnp.asarray(v)
             for k, v in B._build_coeff_maps(idx, mats, dx, dt).items()}
    args = (jnp.asarray(np.asarray(mats.init_temperature, np.float32)[idx]),
            jnp.zeros(shape, jnp.float32), jnp.asarray(Q),
            jnp.zeros(n, jnp.int32), jnp.ones(n, jnp.bool_), coeff,
            jnp.zeros(1, jnp.int32), jnp.float32(37.0))
    exe = B._bhte_scan.lower(*args, n_steps=n).compile()
    jax.block_until_ready(exe(*args))
    rates = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(exe(*args))
        rates.append(np.prod(shape) * n / (time.perf_counter() - t0) / 1e9)
    _emit("bhte", rates, "Gcell-updates/s")


ALL = {
    "fdtd_fluid_ct": bench_fluid_ct,
    "fdtd_visco_label": bench_visco_label,
    "fdtd_visco_narrow": bench_visco_narrow,
    "fdtd_dome": bench_dome,
    "rayleigh": bench_rayleigh,
    "bhte": bench_bhte,
}
_DEVICE = {}


def main(names=None):
    names = names or sys.argv[1:] or list(ALL)
    unknown = set(names) - set(ALL)
    if unknown:
        sys.exit(f"unknown cells {sorted(unknown)}; known: {sorted(ALL)}")
    _DEVICE.update(device_info())
    for n in names:
        ALL[n]()


if __name__ == "__main__":
    main()
