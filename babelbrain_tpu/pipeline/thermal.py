"""Step-3 thermal pipeline: losses analysis, BHTE schedule, safety metrics.

Re-implements `ThermalModeling/CalculateTemperatureEffects.py` in JAX:

* ``analyze_losses`` — PressureRatio to hit the requested Isppa at the focal
  spot and RatioLosses from plane-integral acoustic energies at the water /
  tissue maxima (`:94-256`).
* ``run_sonication`` — repetition/group on-off schedule of BHTE runs with
  duty cycle (`RunBHTECycles :259-459`), executed as a single scan schedule
  (the reference restarts subprocesses to dodge GPU driver leaks — not
  needed here).
* ``safety_metrics`` — TI/TIS/TIC (max temperature rises in brain / skin /
  skull), CEM43 doses, MI = p_MPa/sqrt(f_MHz), Isppa/Ispta (`:1110-1190`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..materials.thermal import ThermalMaterialList, build_thermal_material_list
from ..ops.bhte import bhte_run


def tissue_region_masks(material_map, *, ct_mode: bool, segmented: bool):
    """(skin, skull, brain) boolean masks per the reference's conventions
    (`CalculateTemperatureEffects.py:885-906`)."""
    mm = np.asarray(material_map)
    skin = mm == 1
    if ct_mode:
        if segmented:
            brain = np.isin(mm, [2, 3, 4, 5])
            skull = mm >= 6
        else:
            brain = mm == 2
            skull = mm > 2
    else:
        if segmented:
            brain = np.isin(mm, [4, 5, 6, 7])
        else:
            brain = mm == 4
        skull = (mm > 1) & (mm < 4)
    return skin, skull, brain


def plane_energy(p_plane, density_plane, sos_plane, dx):
    """Acoustic energy flux integral over a z-plane (`:150-152`)."""
    return float(
        (p_plane**2 / (2.0 * density_plane * sos_plane) * dx * dx).sum()
    )


def analyze_losses(
    p_amp,
    p_amp_water,
    material_map,
    mats: ThermalMaterialList,
    target_ijk,
    dx: float,
    isppa_w_cm2: float,
    *,
    brain_mask,
    single_point_ratio: bool = False,
    segmented: bool = False,
    fixed_acoustic_power: float = 0.0,
):
    """Return (pressure_ratio, ratio_losses) — `AnalyzeLosses` equivalent
    (`CalculateTemperatureEffects.py:94-256`).

    pressure_ratio scales the simulated field so the focal-spot intensity
    equals ``isppa_w_cm2``; ratio_losses compares tissue vs water plane
    energies at the tissue-peak plane, swapped for the water-peak-plane
    ratio when it exceeds it by the reference's +0.2 guard (`:236-238`).
    ``single_point_ratio`` is the DomeTx peak-ratio branch (`:201-203`);
    ``fixed_acoustic_power`` (W) overrides the losses with the benchmark
    power normalization (`:241-245,252-254`). PressureRatio uses the
    acoustic properties at the requested target voxel, or at the tissue
    peak when ``segmented`` (`:246-256`).
    """
    mm = np.asarray(material_map)
    rho = np.asarray(mats.density)[mm]
    sos = np.asarray(mats.sos)[mm]

    p_tissue = np.where(brain_mask, p_amp, 0.0)
    czr = np.unravel_index(np.argmax(p_tissue), p_tissue.shape)

    pw = np.asarray(p_amp_water).copy()
    pw[~brain_mask] = 0.0
    czw = np.unravel_index(np.argmax(pw), pw.shape)

    e_w_at_t = None
    if single_point_ratio:
        ratio_losses = float(p_tissue.max() ** 2 / pw.max() ** 2)
    else:
        rho0 = float(mats.density[0])
        sos0 = float(mats.sos[0])
        e_w = plane_energy(pw[:, :, czw[2]], rho0, sos0, dx)
        e_t_at_w = plane_energy(
            p_tissue[:, :, czw[2]], rho[:, :, czw[2]], sos[:, :, czw[2]], dx
        )
        e_w_at_t = plane_energy(pw[:, :, czr[2]], rho0, sos0, dx)
        e_t = plane_energy(
            p_tissue[:, :, czr[2]], rho[:, :, czr[2]], sos[:, :, czr[2]], dx
        )
        ratio_losses = e_t / max(e_w_at_t, 1e-30)
        ratio_loc = e_t_at_w / max(e_w, 1e-30)
        if ratio_losses > ratio_loc + 0.2:
            ratio_losses = ratio_loc
        if fixed_acoustic_power > 0.0:
            ratio_losses = fixed_acoustic_power / max(e_w_at_t, 1e-30)

    if fixed_acoustic_power > 0.0 and not single_point_ratio:
        return float(np.sqrt(ratio_losses)), ratio_losses

    if segmented or target_ijk is None:
        i, j, k = czr
    else:
        i, j, k = (int(v) for v in target_ijk)
    p_target = np.sqrt(isppa_w_cm2 * 1e4 * 2.0 * sos[i, j, k] * rho[i, j, k])
    pressure_ratio = float(p_target / max(p_tissue.max(), 1e-30))
    return pressure_ratio, ratio_losses


@dataclass
class SonicationParams:
    """One thermal-profile entry (`Profiles/Thermal_Profile_*.yaml` contract)."""

    duration_on: float  # s
    duration_off: float  # s
    duty_cycle: float = 0.3
    prf: float = 1500.0
    repetitions: int = 1
    grouped_sonications: int = 1
    pause_between_groups: float = 0.0
    isppa: float = 5.0  # W/cm^2


@dataclass
class ThermalResult:
    temperature_end: np.ndarray
    temperature_peak: np.ndarray
    dose: np.ndarray  # CEM43 seconds
    monitor: np.ndarray  # (4, n_samples)
    metrics: dict = field(default_factory=dict)
    pressure_ratio: float = 1.0
    ratio_losses: float = 1.0
    # step index of each monitor sample
    monitor_steps: np.ndarray | None = None


def run_sonication(
    p_amp,
    p_amp_water,
    material_map,
    acoustic_materials,
    dx: float,
    target_ijk,
    params: SonicationParams,
    *,
    ct_mode: bool = False,
    segmented: bool = False,
    baseline_temperature: float = 37.0,
    dt: float = 0.01,
    initial_temperature=None,
    initial_dose=None,
    frequency: float = 7e5,
    tx_is_dome: bool = False,
) -> ThermalResult:
    """Full Step-3 computation for one DC/PRF/Duration combination."""
    mats = build_thermal_material_list(
        np.asarray(acoustic_materials),
        ct_mode=ct_mode,
        segmented_brain=segmented,
        baseline_temperature=baseline_temperature,
    )
    skin, skull, brain = tissue_region_masks(
        material_map, ct_mode=ct_mode, segmented=segmented
    )

    pressure_ratio, ratio_losses = analyze_losses(
        p_amp,
        p_amp_water,
        material_map,
        mats,
        target_ijk,
        dx,
        params.isppa,
        brain_mask=brain,
        single_point_ratio=tx_is_dome,
        segmented=segmented,
    )
    p = np.asarray(p_amp) * pressure_ratio

    n_on = int(round(params.duration_on / dt))
    n_off = int(round(params.duration_off / dt))
    n_pause = int(round(params.pause_between_groups / dt))
    schedule = []
    for g in range(params.grouped_sonications):
        for _ in range(params.repetitions):
            schedule.append((0, n_on, True))
            if n_off:
                schedule.append((0, n_off, False))
        if n_pause and g < params.grouped_sonications - 1:
            schedule.append((0, n_pause, False))

    # preliminary single-shot run to locate the hottest voxels per region
    pre = bhte_run(
        p,
        material_map,
        mats,
        dx,
        [(0, n_on, True)],
        dt=dt,
        duty_cycle=params.duty_cycle,
        initial_temperature=initial_temperature,
        initial_dose=initial_dose,
        arterial_temperature=baseline_temperature,
    )

    def hot(mask):
        t = np.where(mask, pre.peak_temperature, -np.inf)
        return np.unravel_index(np.argmax(t), t.shape)

    m_skin, m_brain, m_skull = hot(skin), hot(brain), hot(skull)
    monitors = [m_skin, m_brain, m_skull, tuple(int(v) for v in target_ijk)]

    res = bhte_run(
        p,
        material_map,
        mats,
        dx,
        schedule,
        dt=dt,
        duty_cycle=params.duty_cycle,
        monitor_points=np.asarray(monitors),
        initial_temperature=initial_temperature,
        initial_dose=initial_dose,
        arterial_temperature=baseline_temperature,
    )

    peak = res.peak_temperature
    ti = float(np.where(brain, peak, -np.inf).max()) - baseline_temperature
    tis = float(np.where(skin, peak, -np.inf).max()) - baseline_temperature
    tic = float(np.where(skull, peak, -np.inf).max()) - baseline_temperature
    cem_brain = float(np.where(brain, res.dose, 0.0).max()) / 60.0
    cem_skin = float(np.where(skin, res.dose, 0.0).max()) / 60.0
    cem_skull = float(np.where(skull, res.dose, 0.0).max()) / 60.0

    p_brain_max = float(np.where(brain, p, 0.0).max())
    mi = p_brain_max / 1e6 / np.sqrt(frequency / 1e6)
    i0, j0, k0 = np.unravel_index(
        np.argmax(np.where(brain, p, 0.0)), p.shape
    )
    mm = np.asarray(material_map)
    rho_b = mats.density[mm[i0, j0, k0]]
    sos_b = mats.sos[mm[i0, j0, k0]]
    max_isppa = p_brain_max**2 / (2 * rho_b * sos_b) / 1e4
    metrics = {
        "TI": ti,
        "TIS": tis,
        "TIC": tic,
        "CEMBrain": cem_brain,
        "CEMSkin": cem_skin,
        "CEMSkull": cem_skull,
        "MI": mi,
        "MaxBrainPressure": p_brain_max,
        "MaxIsppa": max_isppa,
        "MaxIspta": max_isppa * params.duty_cycle,
        "Isppa": params.isppa,
        "Ispta": params.isppa * params.duty_cycle,
        "mSkin": m_skin,
        "mBrain": m_brain,
        "mSkull": m_skull,
    }
    return ThermalResult(
        temperature_end=res.temperature,
        temperature_peak=peak,
        dose=res.dose,
        monitor=res.monitor,
        metrics=metrics,
        pressure_ratio=pressure_ratio,
        ratio_losses=ratio_losses,
        monitor_steps=res.monitor_steps,
    )


def run_all_combinations(
    p_amp,
    p_amp_water,
    material_map,
    acoustic_materials,
    dx: float,
    target_ijk,
    combinations: list,
    *,
    out_base: str | None = None,
    concatenate: bool = False,
    ct_mode: bool = False,
    segmented: bool = False,
    baseline_temperature: float = 37.0,
    dt: float = 0.01,
    frequency: float = 7e5,
    tx_is_dome: bool = False,
    extra_data: dict | None = None,
):
    """Run every DC/PRF/Duration combination of a thermal profile and
    consolidate the per-combination results.

    The reference's `CalculateThermalProcess`
    (`Babel_Thermal/CalculateThermalProcess.py:54-123`): one BHTE run per
    profile entry (optionally *concatenated* — each sonication seeds the next
    run's initial temperature/dose, `prevSimulationResultsFile`), the
    per-combination safety fields collected into ``AllData`` with an
    ``Index`` array ``[DC, PRF, Duration, DurationOff, Isppa]`` per row, and
    written to ``<base>_AllCombinations.h5`` (+ ``.mat``). Per-combination
    ThermalField h5 files follow the `GetThermalOutName` contract.

    Returns (results: list[ThermalResult], consolidated: dict).
    """
    from . import io as pio

    all_cases = []
    index = []
    results = []
    init_t = init_d = None
    for params in combinations:
        res = run_sonication(
            p_amp,
            p_amp_water,
            material_map,
            acoustic_materials,
            dx,
            target_ijk,
            params,
            ct_mode=ct_mode,
            segmented=segmented,
            baseline_temperature=baseline_temperature,
            dt=dt,
            initial_temperature=init_t,
            initial_dose=init_d,
            frequency=frequency,
            tx_is_dome=tx_is_dome,
        )
        results.append(res)
        if concatenate:
            init_t, init_d = res.temperature_end, res.dose
        n_mon = res.monitor.shape[-1]
        mon_steps = (
            res.monitor_steps
            if res.monitor_steps is not None
            else np.arange(n_mon)
        )
        sub = {
            "TempProfileTarget": res.monitor[-1],
            "TimeProfileTarget": np.asarray(mon_steps) * dt,
            "p_map": np.asarray(p_amp)[p_amp.shape[0] // 2] * res.pressure_ratio,
            "DurationUS": params.duration_on,
            "DurationOff": params.duration_off,
            "DutyCycle": params.duty_cycle,
            "PRF": params.prf,
            "BaselineTemperature": baseline_temperature,
            "Repetitions": params.repetitions,
            "NumberGroupedSonications": params.grouped_sonications,
            "PauseBetweenGroupedSonications": params.pause_between_groups,
        }
        for k in ("MaxBrainPressure", "MaxIsppa", "MaxIspta", "TI", "TIC",
                  "TIS", "Isppa", "Ispta", "MI"):
            sub[k] = res.metrics[k]
        all_cases.append(sub)
        index.append([
            params.duty_cycle, params.prf, params.duration_on,
            params.duration_off, round(params.isppa, 1),
        ])
        if out_base is not None:
            name = thermal_out_name(
                out_base, params.duration_on, params.duration_off,
                params.duty_cycle, params.isppa, params.prf,
                params.repetitions,
            )
            per = dict(sub)
            per.update(
                FinalTemp=res.temperature_end,
                FinalDose=res.dose,
                TemperaturePoints=res.monitor,
                RatioLosses=res.ratio_losses,
                PressureRatio=res.pressure_ratio,
                dt=dt,
            )
            pio.save_dict_h5(per, name + ".h5", compression="blosc")

    consolidated = {
        "AllData": {str(i): c for i, c in enumerate(all_cases)},
        "Index": np.asarray(index),
        "MaterialMap": np.asarray(material_map),
        "TargetLocation": np.asarray(target_ijk),
        "dt": dt,
    }
    if extra_data:
        consolidated.update(extra_data)
    if out_base is not None:
        pio.save_dict_h5(consolidated, out_base + "_AllCombinations.h5",
                     compression="blosc")
        # .mat twin: AllData as a cell array of structs (digit field names
        # are invalid in MATLAB)
        mat_dict = dict(consolidated)
        mat_dict["AllData"] = np.asarray(all_cases, dtype=object)
        save_thermal_mat(out_base + "_AllCombinations.mat", mat_dict)
    return results, consolidated


def thermal_out_name(
    base: str,
    duration_on: float,
    duration_off: float,
    duty_cycle: float,
    isppa: float,
    prf: float,
    repetitions: int,
) -> str:
    """Output filename contract (`GetThermalOutName`,
    `CalculateTemperatureEffects.py:56-92`)."""
    if duration_on >= 1 and duration_off >= 1:
        suffix = "-ThermalField-Duration-%i-DurationOff-%i-DC-%i-Isppa-%2.1fW-PRF-%iHz" % (
            duration_on,
            duration_off,
            duty_cycle * 1000,
            isppa,
            prf,
        )
    else:
        suffix = (
            "-ThermalField-Duration-%3.2f-DurationOff-%3.2f-DC-%i-Isppa-%2.1fW-PRF-%iHz"
            % (duration_on, duration_off, duty_cycle * 1000, isppa, prf)
        )
    if repetitions > 1:
        suffix += "-%iReps" % repetitions
    return base + suffix


def save_thermal_mat(path: str, save_dict: dict):
    """Write the MATLAB twin of the thermal h5 (the reference saves both,
    `CalculateTemperatureEffects.py:1234-1235`)."""
    from scipy.io import savemat

    clean = {}
    for k, v in save_dict.items():
        kk = k.replace("-", "_")
        clean[kk] = v if not isinstance(v, dict) else v
    savemat(path, clean)


def focal_metrics(p_amp, spacing_m: float, threshold_db: float = -6.0):
    """-6 dB focal-spot metrics (`BabelBrain/_BabelBaseTx.py:48`
    `CalcVolumetricMetrics` capability): ellipsoid axis lengths through the
    peak, volume of the connected -6 dB region, and the peak location."""
    p = np.asarray(p_amp)
    peak = p.max()
    thr = peak * 10 ** (threshold_db / 20.0)
    pk = np.unravel_index(np.argmax(p), p.shape)
    region = p >= thr

    # connected component containing the peak
    from ..ops.imaging import label_components

    labels, _ = label_components(region)
    region = labels == labels[pk]

    axes_mm = []
    for ax in range(3):
        idx = [pk[0], pk[1], pk[2]]
        idx[ax] = slice(None)
        line = region[tuple(idx)]
        axes_mm.append(float(line.sum()) * spacing_m * 1e3)
    volume_mm3 = float(region.sum()) * (spacing_m * 1e3) ** 3

    # moments-based ellipsoid axes, the reference's exact definition
    # (`_BabelBaseTx.py:23-46`): second central moments of the region ->
    # sqrt(20 * eigenvalues), descending
    ii, jj, kk = np.nonzero(region)
    pts = np.stack([ii, jj, kk], axis=1).astype(np.float64)
    c = pts.mean(axis=0)
    d = pts - c
    S = d.T @ d / pts.shape[0]
    eigvals = np.sort(np.linalg.eigvalsh(S))[::-1]
    ell = tuple(float(np.sqrt(20.0 * max(e, 0.0))) * spacing_m * 1e3
                for e in eigvals)
    return {
        "peak_Pa": float(peak),
        "peak_ijk": tuple(int(v) for v in pk),
        "axes_mm": tuple(axes_mm),
        "ellipsoid_axes_mm": ell,
        "centroid_ijk": tuple(float(v) for v in c),
        "volume_mm3": volume_mm3,
    }


def rescale_isppa(result: ThermalResult, p_amp, new_isppa: float, old_isppa: float):
    """Return the pressure map scaled for a new Isppa without re-simulating
    the acoustics (fields are linear; the reference's Babel_Thermal
    `OverWriteIsppa` display path, `Babel_Thermal.py:314`). The BHTE must be
    rerun on the scaled map for new thermal metrics."""
    scale = float(np.sqrt(new_isppa / old_isppa))
    return np.asarray(p_amp) * result.pressure_ratio * scale


def export_summary_csv(path: str, rows: list[dict]):
    """Write the thermal-summary table (one row per DC/duration combination;
    the Babel_Thermal export capability, `Babel_Thermal.py:708,786`)."""
    import csv

    keys = [
        "Isppa", "DC", "PRF", "DurationOn", "DurationOff", "Repetitions",
        "TI", "TIS", "TIC", "CEMBrain", "CEMSkin", "CEMSkull", "MI",
        "MaxBrainPressure", "MaxIsppa", "MaxIspta", "RatioLosses",
    ]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
        w.writeheader()
        for r in rows:
            w.writerow(r)


def summary_row(params: SonicationParams, result: ThermalResult) -> dict:
    row = dict(result.metrics)
    row.update(
        Isppa=params.isppa, DC=params.duty_cycle, PRF=params.prf,
        DurationOn=params.duration_on, DurationOff=params.duration_off,
        Repetitions=params.repetitions, RatioLosses=result.ratio_losses,
    )
    return row
