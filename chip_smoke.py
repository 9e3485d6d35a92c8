#!/usr/bin/env python
"""Run Step 1 -> 2 -> 3 once on one NVIDIA GPU and check every result.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the multi-card comparisons only

One card, in order:

1. device check: JAX must report a GPU; prints ``nvidia-smi``'s name and
   power limit;
2. reference comparisons: the FDTD goldens, the digital-head golden, the
   CT and label FDTD grids on the GPU against the CPU, Rayleigh against a
   float64 direct sum, BHTE on the GPU against the CPU, and the affine
   resampler against ``scipy.ndimage.affine_transform``;
3. the CT case: ``run_case`` on an adult-size procedural head, CTX_500 at
   500 kHz and 6 PPW, with a 30 s on / 30 s off thermal schedule;
4. the label case: the same without CT (viscoelastic FDTD with shear).

``--four-cards`` runs only: the CT-case FDTD over a 4-card x mesh, the
label-case FDTD over a 2x2 (x, y) mesh, and ``run_multipoint`` fanned out
over 4 cards, each against the same work on one card (12 carrier cycles;
the FDTD grids bucketed to a multiple of 4 cells; multipoint at 3 PPW).

Every phase prints its wall time; a failure exits non-zero before the last
line. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import collections
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


try:
    from babelbrain_tpu.utils.compile_cache import configure_compile_cache
except ImportError:
    fail("chip_smoke.py runs from the root of a checkout of the repository")

CACHE_DIR = configure_compile_cache()
os.environ.setdefault("BBT_TELEMETRY", "0")  # no writes outside the checkout

import jax  # noqa: E402
import numpy as np  # noqa: E402

from babelbrain_tpu.utils import open_spans  # noqa: E402

OUT_DIR = os.path.join(HERE, ".smoke_out")
F0 = 500e3
PPW = 6.0
TARGET = [0.0, 0.0, 40.0]  # RAS mm, ~50 mm below the scalp
DIRECTION = [0.0, 0.0, -1.0]

# ---------------------------------------------------------------------------
# phases, timing and compile accounting
# ---------------------------------------------------------------------------

_PHASE = ["start"]
_COMPILES = collections.defaultdict(lambda: [0, 0.0])


def _on_duration(event, duration, **kw):
    if event != "/jax/core/compile/backend_compile_duration":
        return
    spans = [s for s in open_spans() if s.startswith("CTS:L2")]
    stage = _PHASE[0] + (" / " + spans[-1].split(": ", 1)[1] if spans else "")
    _COMPILES[stage][0] += 1
    _COMPILES[stage][1] += duration


jax.monitoring.register_event_duration_secs_listener(_on_duration)


@contextlib.contextmanager
def phase(name):
    _PHASE[0] = name
    print(f"=== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    wall = time.perf_counter() - t0
    for stage, (n, s) in sorted(_COMPILES.items()):
        if stage == name or stage.startswith(name + " / "):
            print(f"compile {stage}: {n} compilations, {s:.1f} s")
    print(f"phase {name}: {wall:.1f} s wall", flush=True)


def check(ok, what):
    print(("pass  " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        fail(what)


def rel_errors(got, ref):
    """(rel-L2, peak-relative L-inf) of ``got`` against ``ref``."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    l2 = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    return float(l2), float(np.abs(got - ref).max() / np.abs(ref).max())


def cpu_device():
    return jax.devices("cpu")[0]


def report_fdtd_runs(tag):
    """Print the FDTD calls made since the last report, with their rates."""
    from babelbrain_tpu.ops.fdtd import fdtd_run_log

    for r in fdtd_run_log(reset=True):
        cells = r["cases"] * int(np.prod(r["shape"]))
        rate = cells * r["n_steps"] / r["run_s"] / 1e9
        kind = "visco" if r["shear"] else "fluid"
        print(f"fdtd {tag}: {kind} grid {r['shape']} x{r['cases']} "
              f"{r['n_steps']} steps on {r['platform']}: run "
              f"{r['run_s']:.2f} s ({rate:.3f} Gcell-updates/s), compile "
              f"{r['compile_s']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def device_check(n_cards):
    devs = jax.devices()
    d = devs[0]
    print(f"jax {jax.__version__}: {len(devs)} x {d.platform} "
          f"({d.device_kind}); compile cache {CACHE_DIR}")
    if d.platform != "gpu":
        fail(f"no GPU: JAX reports platform {d.platform!r}")
    if len(devs) < n_cards:
        fail(f"{n_cards} cards needed, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    for line in smi:
        print(line)
    x = jax.device_put(np.arange(1 << 20, dtype=np.float32), d)
    check(float(x.sum()) == float(np.arange(1 << 20, dtype=np.float64).sum()),
          "a reduction on the card returns the host value")
    from babelbrain_tpu.native import native_available

    for lib in ("voxelize", "blosc"):
        print(f"native {lib}: "
              + ("built from babelbrain_tpu/native/" + lib + ".cpp"
                 if native_available(lib) else "not built, NumPy path runs"))
    try:
        import h5py  # noqa: F401

        have_h5 = True
        print("h5py present: HDF5 outputs are written and checked")
    except ImportError:
        have_h5 = False
        print("h5py not installed: run_case runs with write_h5=False, so "
              "_DataForSim.h5 and _ThermalField.h5 are not written; the "
              "NIfTI outputs and the in-memory DataForSim/thermal dicts "
              "are checked instead")
    return have_h5


# ---------------------------------------------------------------------------
# the cases: head, domain, configuration
# ---------------------------------------------------------------------------

_HEAD = []


def adult_head():
    """Adult-size procedural head: 1 mm voxels, ~85 mm outer skull."""
    if not _HEAD:
        from babelbrain_tpu.pipeline.phantom import build_head

        t0 = time.perf_counter()
        _HEAD.append(build_head(n=200, voxel_mm=1.0, skull_radius_mm=85.0))
        print(f"adult head phantom 200^3 at 1 mm: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return _HEAD[0]


def case_domain(ct_mode, shape_bucket=0, ppw=None):
    """The FDTD domain ``run_case`` builds for the smoke's CTX_500 case,
    through the same Step-1 and Step-2 set-up calls; returns
    ``(dom, tx, source_plane)``."""
    ppw = PPW if ppw is None else ppw
    from babelbrain_tpu.materials.ct_mapping import map_hu_to_properties
    from babelbrain_tpu.pipeline.acoustic import (
        position_transducer,
        source_plane_from_field,
    )
    from babelbrain_tpu.pipeline.domain import (
        build_ct_materials,
        build_domain,
        build_label_materials,
        fit_domain_offsets,
    )
    from babelbrain_tpu.pipeline.profiles import (
        TRANSDUCER_REGISTRY,
        build_transducer,
    )
    from babelbrain_tpu.pipeline.step1 import generate_mask
    from babelbrain_tpu.ops.rayleigh import rayleigh_field

    labels, ct, _, _, _, aff = adult_head()
    s1 = generate_mask(
        labels, aff, TARGET, DIRECTION, F0, ppw,
        ct_data=ct if ct_mode else None, ct_affine=aff if ct_mode else None,
    )
    if ct_mode:
        rho, sos, att = map_hu_to_properties(s1.unique_hu, F0, "Webb-Marsac")
        materials = build_ct_materials(F0, False, rho, sos, att)
    else:
        materials = build_label_materials(F0, False)
    spec = TRANSDUCER_REGISTRY["CTX_500"]
    offsets, shrinks = fit_domain_offsets(
        np.flip(s1.mask, axis=2), s1.dx_mm * 1e-3, spec.diameter,
        spec.focal_length, tx_mech_adjust=(0.0, 0.0, 0.0),
    )
    air = s1.air_mask if ct_mode and s1.air_mask is not None else None
    dom = build_domain(
        s1.mask, F0, ppw, materials=materials,
        ct_index_map=s1.ct_index if ct_mode else None,
        air_mask=air if air is not None and air.any() else None,
        offsets=offsets, shrink_cells=shrinks, shape_bucket=shape_bucket,
    )
    tx = position_transducer(build_transducer(spec, F0), dom,
                             spec.focal_length)
    # the Rayleigh field on the source plane only: the FDTD drive
    xp, yp = np.meshgrid(dom.x_vec, dom.y_vec, indexing="ij")
    pts = np.stack([xp.ravel(), yp.ravel(),
                    np.full(xp.size, dom.z_vec[dom.source_z])], 1)
    k = 2 * np.pi * F0 / dom.materials[0, 1]
    u0 = np.full(tx.num_subelements, 60e3, np.complex64)
    plane = np.asarray(rayleigh_field(k, tx.centers, tx.areas, u0, pts))
    u2 = np.zeros(dom.material_map.shape, np.complex64)
    u2[:, :, dom.source_z] = plane.reshape(xp.shape)
    return dom, tx, source_plane_from_field(dom, u2)


def fdtd_inputs(dom, src, n_cycles=None):
    """``run_fdtd`` arguments for a domain, optionally cut to ``n_cycles``
    carrier cycles with the DFT over the last two."""
    import dataclasses

    from babelbrain_tpu.pipeline.acoustic import _make_grid

    grid = _make_grid(dom)
    if n_cycles is not None:
        n = n_cycles * dom.ppp
        grid = dataclasses.replace(grid, n_steps=n, sensor_start=n - 2 * dom.ppp)
    kw = dict(source_amp=np.abs(src), source_phase=np.angle(src),
              reflector_mask=dom.meta.get("reflector_mask"))
    return (dom.material_map, dom.materials, grid), kw


# ---------------------------------------------------------------------------
# 2. reference comparisons
# ---------------------------------------------------------------------------


def check_goldens():
    import test_regression as tr

    for name, tol_l2, tol_linf in tr.GOLDENS:
        l2, linf = tr.golden_errors(name, tr._run_config(name))
        check(l2 < tol_l2 and linf < tol_linf,
              f"golden {name}: rel-L2 {l2:.2e} (< {tol_l2}), rel-Linf "
              f"{linf:.2e} (< {tol_linf})")
    report_fdtd_runs("golden")


def check_digital_head():
    import test_digital_head as tdh

    from babelbrain_tpu.pipeline.phantom import build_head
    from babelbrain_tpu.pipeline.profiles import (
        TRANSDUCER_REGISTRY,
        TransducerSpec,
    )

    TRANSDUCER_REGISTRY["HeadTest"] = TransducerSpec(
        "HeadTest", "single", diameter=30e-3, focal_length=55e-3,
        frequencies=(500e3,),
    )
    head = build_head(n=tdh.N, voxel_mm=tdh.VOX, skull_radius_mm=60.0)
    res = tdh.run_ct_case(head, "HeadTest", os.path.join(OUT_DIR, "dh"),
                          write_h5=False)
    dpk, dpos, l2 = tdh.golden_errors(res["data_for_sim"])
    check(dpk < 0.01 and dpos < tdh.VOX and l2 < 0.05,
          f"digital-head CT golden: peak {dpk:.2e} (< 0.01), focus shift "
          f"{dpos:.2f} mm (< {tdh.VOX}), crop rel-L2 {l2:.2e} (< 0.05)")
    report_fdtd_runs("digital head")


# GPU vs CPU on p_amp: the two backends contract FMAs and order sums
# differently, so they agree to a few float32 ulps (~1.5e-7 rel-L2 and
# ~3.5e-7 rel-Linf measured on an H100); a TF32 product or a changed
# stencil coefficient moves p_amp by 1e-3 or more
FDTD_TOL_L2 = 1e-5
FDTD_TOL_LINF = 1e-5


def check_fdtd_real_width(ct_mode):
    """The case's own FDTD grid, cut to 4 carrier cycles, on the GPU and
    on the CPU in this process."""
    from babelbrain_tpu.ops.fdtd import run_fdtd

    dom, tx, src = case_domain(ct_mode)
    args, kw = fdtd_inputs(dom, src, n_cycles=4)
    gpu = run_fdtd(*args, **kw)
    with jax.default_device(cpu_device()):
        cpu = run_fdtd(*args, **kw)
    report_fdtd_runs("real width " + ("CT" if ct_mode else "label"))
    l2, linf = rel_errors(gpu["p_amp"], cpu["p_amp"])
    check(np.isfinite(gpu["p_amp"]).all() and cpu["p_amp"].max() > 0
          and l2 <= FDTD_TOL_L2 and linf <= FDTD_TOL_LINF,
          f"FDTD {'CT fluid' if ct_mode else 'label visco'} grid "
          f"{args[2].shape}, {args[2].n_steps} steps: GPU vs CPU p_amp "
          f"rel-L2 {l2:.2e} (<= {FDTD_TOL_L2}), rel-Linf {linf:.2e} "
          f"(<= {FDTD_TOL_LINF})")
    return dom, tx


def check_rayleigh(dom, tx):
    """``rayleigh_field`` for the CTX_500 mesh against a float64 NumPy
    direct sum on 4096 sampled grid points."""
    from babelbrain_tpu.ops.rayleigh import rayleigh_field

    rng = np.random.default_rng(0)
    n = 4096
    ii = rng.integers(0, len(dom.x_vec), n)
    jj = rng.integers(0, len(dom.y_vec), n)
    kk = rng.integers(dom.source_z + 1, len(dom.z_vec), n)
    pts = np.stack([dom.x_vec[ii], dom.y_vec[jj], dom.z_vec[kk]], 1)
    k = 2 * np.pi * F0 / dom.materials[0, 1]
    u0 = np.exp(1j * rng.uniform(-np.pi, np.pi, tx.num_subelements))
    got = np.asarray(rayleigh_field(k, tx.centers, tx.areas, u0, pts))
    c = np.asarray(tx.centers, np.float64)
    w = 1j * k / (2 * np.pi) * u0 * np.asarray(tx.areas, np.float64)
    ref = np.zeros(n, np.complex128)
    for s in range(0, n, 256):
        r = np.linalg.norm(pts[s:s + 256, None, :] - c[None], axis=-1)
        ref[s:s + 256] = (np.exp(-1j * k * r) / r) @ w
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    kr = float(k * np.linalg.norm(pts[:, None] - c[None, ::97], axis=-1).max())
    check(err <= 1e-3,
          f"Rayleigh {tx.num_subelements} sources x {n} points (k*r up to "
          f"{kr:.0f}): rel-Linf vs float64 direct sum {err:.2e} (<= 1e-3)")


def check_bhte(dom):
    """``_bhte_scan`` on the GPU against the CPU, same schedule, on the
    thermal (mask-frame) grid of the CT case."""
    from babelbrain_tpu.materials import build_thermal_material_list
    from babelbrain_tpu.ops.bhte import bhte_run

    mm = dom.crop_and_unflip(dom.material_map).astype(np.uint32)
    mats = build_thermal_material_list(
        np.asarray(dom.materials), ct_mode=True, segmented_brain=False
    )
    # a 2 MPa beam along z through the target, heating scalp, skull and
    # brain by tens of degrees within the schedule
    ti, tj = (s // 2 for s in mm.shape[:2])
    x = (np.arange(mm.shape[0]) - ti)[:, None, None] * dom.dx
    y = (np.arange(mm.shape[1]) - tj)[None, :, None] * dom.dx
    p = np.broadcast_to(
        2e6 * np.exp(-(x ** 2 + y ** 2) / (2 * 3e-3 ** 2)), mm.shape
    ).astype(np.float32)
    sched = [(0, 100, True), (0, 50, False), (0, 50, True)]
    kw = dict(dt=0.01, duty_cycle=0.3, arterial_temperature=37.0,
              monitor_points=[(ti, tj, mm.shape[2] // 2)])
    t0 = time.perf_counter()
    gpu = bhte_run(p, mm, mats, dom.dx, sched, **kw)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    with jax.default_device(cpu_device()):
        cpu = bhte_run(p, mm, mats, dom.dx, sched, **kw)
    t_cpu = time.perf_counter() - t0
    steps = sum(n for _, n, _ in sched)
    print(f"bhte grid {mm.shape} {steps} steps: GPU {t_gpu:.2f} s, CPU "
          f"{t_cpu:.2f} s, compile included")
    bhte_rate(mm, mats, dom.dx)
    t_start = np.asarray(mats.init_temperature)[mm]
    rise_g = gpu.temperature - t_start
    rise_c = cpu.temperature - t_start
    d_rise = float(np.abs(rise_g - rise_c).max() / np.abs(rise_c).max())
    d_dose = float(np.abs(gpu.dose - cpu.dose).max() / cpu.dose.max())
    check(np.isfinite(gpu.temperature).all() and rise_c.max() > 5.0
          and d_rise <= 1e-5 and d_dose <= 1e-3,
          f"BHTE {steps}-step 3-segment schedule: max rise "
          f"{rise_c.max():.1f} C; GPU vs CPU rise rel {d_rise:.2e} "
          f"(<= 1e-5), CEM43 rel {d_dose:.2e} (<= 1e-3)")


def bhte_rate(mm, mats, dx):
    """Gcell-updates/s of the XLA BHTE scan alone on the card, for the
    material map ``mm`` (the cost does not depend on the heating)."""
    from babelbrain_tpu.ops import bhte

    n = 1000
    shape = mm.shape
    z = np.zeros(shape, np.float32)
    coeff = {k: jax.numpy.asarray(v) for k, v in bhte._build_coeff_maps(
        mm, mats, dx, 0.01).items()}
    args = (jax.numpy.asarray(z + 37.0), jax.numpy.asarray(z),
            jax.numpy.asarray(z[None]), jax.numpy.zeros(n, np.int32),
            jax.numpy.ones(n, bool), coeff, jax.numpy.zeros(1, np.int32),
            jax.numpy.float32(37.0))
    exe = bhte._bhte_scan.lower(*args, n_steps=n).compile()
    jax.block_until_ready(exe(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(exe(*args))
    dt = time.perf_counter() - t0
    rate = np.prod(shape) * n / dt / 1e9
    print(f"bhte rate: grid {shape} {n} steps in {dt:.3f} s = "
          f"{rate:.2f} Gcell-updates/s", flush=True)


def check_resample():
    """The card's ``_resample`` (HIGHEST-precision coordinates) against
    ``scipy.ndimage.affine_transform`` on a 256^3 volume."""
    import scipy.ndimage as ndi

    from babelbrain_tpu.ops.imaging import resample_affine

    rng = np.random.default_rng(1)
    vol = ndi.gaussian_filter(rng.normal(size=(256,) * 3), 4.0)
    vol = (vol / np.abs(vol).max()).astype(np.float32)
    a = np.deg2rad(17.0)
    mat = np.array([[np.cos(a), -np.sin(a), 0.0],
                    [np.sin(a), np.cos(a), 0.0],
                    [0.0, 0.0, 1.0]]) @ np.diag([1.03, 0.97, 1.0])
    off = np.array([30.3, -20.7, 5.2])
    got = resample_affine(vol, mat, off, vol.shape, order=1)
    # zero outside, interpolating across the edge like map_coordinates
    ref = ndi.affine_transform(vol.astype(np.float64), mat, off, order=1,
                               mode="grid-constant")
    err = float(np.abs(got - ref).max())
    check(err <= 1e-4,
          f"_resample 256^3 vs scipy affine_transform: max abs "
          f"{err:.2e} (<= 1e-4 of a unit-range volume)")


# ---------------------------------------------------------------------------
# 3./4. the cases through run_case
# ---------------------------------------------------------------------------


def run_clinical_case(ct_mode, have_h5, expect_shape):
    from babelbrain_tpu.pipeline.runner import CaseConfig, run_case
    from babelbrain_tpu.pipeline.thermal import SonicationParams
    from babelbrain_tpu.utils import clear_spans, recorded_spans

    labels, ct, _, _, _, aff = adult_head()
    name = "ct" if ct_mode else "label"
    cfg = CaseConfig(tx_system="CTX_500", frequency=F0, ppw=PPW,
                     output_dir=os.path.join(OUT_DIR, name), prefix=name)
    clear_spans()
    res = run_case(
        cfg, labels, aff, TARGET, DIRECTION,
        ct_data=ct if ct_mode else None, ct_affine=aff if ct_mode else None,
        thermal_params=SonicationParams(duration_on=30.0, duration_off=30.0,
                                        duty_cycle=0.3, isppa=10.0),
        force_recalc=True, write_h5=have_h5,
    )
    for tag, dt in recorded_spans():
        if tag.startswith("CTS:L2"):
            print(f"stage {tag.split(': ', 1)[1]}: {dt:.1f} s")
    report_fdtd_runs(name + " case")
    dom = res["domain"]
    shape = dom.material_map.shape
    check(tuple(shape) == tuple(expect_shape),
          f"{name} case FDTD grid {shape} is the grid compared on GPU and CPU")
    data = res["data_for_sim"]
    pa = np.asarray(data["p_amp"])
    check(np.isfinite(pa).all() and pa.max() > 0,
          f"{name} case p_amp finite, peak {pa.max() / 1e3:.1f} kPa")
    th = res["thermal"]
    m = th.metrics
    # CEM43 is float32 like the reference's; it overflows to +inf only
    # where a voxel passes ~170 C, which a too-lossy skull can reach
    check(np.isfinite(th.temperature_end).all()
          and np.isfinite(th.temperature_peak).all()
          and not np.isnan(th.dose).any() and (th.dose >= 0).all()
          and th.temperature_peak.max() > 37.0,
          f"{name} case thermal: pressure ratio {th.pressure_ratio:.3g}, "
          f"losses {th.ratio_losses:.3g}, peak {th.temperature_peak.max():.2f}"
          f" C, TI {m['TI']:.3f} C, TIC {m['TIC']:.3f} C, TIS "
          f"{m['TIS']:.3f} C, CEMBrain {m['CEMBrain']:.3e} min")
    files = [res["files"]["mask"]]
    if have_h5:
        files += [res["files"]["acoustic"], res["files"]["thermal"]]
    for f in files:
        check(f is not None and os.path.getsize(f) > 0,
              f"{name} case wrote {os.path.basename(f)}")
    if have_h5:
        from babelbrain_tpu.pipeline.io import load_dict_h5

        back = load_dict_h5(res["files"]["acoustic"])
        check(np.array_equal(np.asarray(back["p_amp"]), pa),
              f"{name} case _DataForSim.h5 reads back p_amp")
    return shape


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


FOUR_CARD_CYCLES = 12  # the front crosses scalp and skull; a case runs ~70
# run_multipoint evaluates Rayleigh on the whole volume once per target and
# path (8 times); at 3 PPW the grid has 8x fewer cells
MULTIPOINT_PPW = 3.0


def four_card_checks():
    import dataclasses

    from babelbrain_tpu.ops.fdtd import run_fdtd
    from babelbrain_tpu.parallel.halo import make_mesh, make_mesh_2d
    from babelbrain_tpu.pipeline.acoustic import run_multipoint

    for ct_mode, mesh, label in (
        (True, make_mesh(4), "CT fluid, 4-card x mesh"),
        (False, make_mesh_2d(2, 2), "label visco, 2x2 (x, y) mesh"),
    ):
        # dims bucketed to a multiple of 4 so the mesh divides the grid
        dom, tx, src = case_domain(ct_mode, shape_bucket=4)
        n = FOUR_CARD_CYCLES * dom.ppp
        dom = dataclasses.replace(dom, n_steps=n, sensor_start=n - 2 * dom.ppp)
        args, kw = fdtd_inputs(dom, src)
        one = run_fdtd(*args, **kw)
        many = run_fdtd(*args, mesh=mesh, **kw)
        report_fdtd_runs(label)
        l2, linf = rel_errors(many["p_amp"], one["p_amp"])
        exact = np.array_equal(many["p_amp"], one["p_amp"])
        check(l2 <= 1e-5 and linf <= 1e-4,
              f"FDTD {label}, grid {args[2].shape}, {args[2].n_steps} steps:"
              f" vs one card rel-L2 {l2:.2e} (<= 1e-5), rel-Linf {linf:.2e}"
              f" (<= 1e-4), bit-exact {exact}")
    mp_dom, mp_tx, _ = case_domain(True, ppw=MULTIPOINT_PPW)
    n = FOUR_CARD_CYCLES * mp_dom.ppp
    mp_dom = dataclasses.replace(mp_dom, n_steps=n,
                                 sensor_start=n - 2 * mp_dom.ppp)
    targets = [np.array([0.0, 0.0, dz]) for dz in (-4e-3, -2e-3, 2e-3, 4e-3)]
    fan, _ = run_multipoint(mp_dom, mp_tx, targets, fanout=True)
    report_fdtd_runs("multipoint fan-out x4")
    seq, _ = run_multipoint(mp_dom, mp_tx, targets, fanout=False)
    report_fdtd_runs("multipoint sequential")
    worst = max(rel_errors(a.p_amp, b.p_amp)[1] for a, b in zip(fan, seq))
    exact = all(np.array_equal(a.p_amp, b.p_amp) for a, b in zip(fan, seq))
    check(worst <= 1e-4,
          f"run_multipoint 4 targets over 4 cards vs sequential on one: "
          f"worst rel-Linf {worst:.2e} (<= 1e-4), bit-exact {exact}")


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card comparisons")
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1
    t_all = time.perf_counter()
    with phase("device"):
        have_h5 = device_check(n_cards)
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    if args.four_cards:
        with phase("four cards"):
            four_card_checks()
    else:
        with phase("references"):
            check_goldens()
            check_digital_head()
            check_resample()
            dom_ct, tx = check_fdtd_real_width(ct_mode=True)
            check_rayleigh(dom_ct, tx)
            check_bhte(dom_ct)
            dom_label, _ = check_fdtd_real_width(ct_mode=False)
        with phase("CT case"):
            run_clinical_case(True, have_h5, dom_ct.material_map.shape)
        with phase("label case"):
            run_clinical_case(False, have_h5, dom_label.material_map.shape)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
          f"({stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB) on device 0")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    print(f"total {time.perf_counter() - t_all:.1f} s wall", flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
