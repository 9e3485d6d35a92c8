"""Pennes bio-heat (BHTE) solver with CEM43 dose (JAX).

Re-implements the thermal solver contract of BabelViscoFDTD's
``BHTE``/``BHTEMultiplePressureFields`` as reconstructed from call sites
(`ThermalModeling/CalculateTemperatureEffects.py:363-394,958-990`, SURVEY.md
section 2.9):

    rho C dT/dt = div(k grad T) + w_b rho_b C_b (T_a - T) + Q
    Q = absorption_fraction * attenuation * p^2 / (rho c) * duty_cycle

with FTCS time stepping (dt = 10 ms default, the reference contract), a
7-point Laplacian with harmonic-mean interface conductivities, perfusion
converted from mL/min/kg, and CEM43 thermal dose accumulated as
``dose += dt * R^(43 - T)`` with R = 0.5 above 43 C and 0.25 below
(`BabelBrain/Babel_Thermal/Babel_Thermal.py:55`).

The whole on/off/multi-field schedule runs inside one ``lax.scan``; per-step
monitor-point temperatures are emitted as scan outputs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# IT'IS blood properties for the perfusion term
BLOOD_DENSITY = 1050.0  # kg/m^3
BLOOD_SPECIFIC_HEAT = 3617.0  # J/kg/C


def _harmonic_mean(a, b):
    return 2.0 * a * b / (a + b + 1e-30)


def _shift(f, offset, axis):
    n = f.shape[axis]
    pad = [(0, 0)] * f.ndim
    idx = [slice(None)] * f.ndim
    if offset >= 0:
        pad[axis] = (0, offset)
        idx[axis] = slice(offset, offset + n)
    else:
        pad[axis] = (-offset, 0)
        idx[axis] = slice(0, n)
    # edge-replicate so boundaries are adiabatic (zero-flux)
    return jnp.pad(f, pad, mode="edge")[tuple(idx)]


@dataclass
class BHTEResult:
    temperature: np.ndarray  # T at end of schedule
    peak_temperature: np.ndarray  # max T over schedule
    dose: np.ndarray  # CEM43 in seconds
    monitor: np.ndarray  # (n_points, n_samples) temperatures
    # global step index of each monitor sample (every step)
    monitor_steps: np.ndarray | None = None


def _build_coeff_maps(mat_idx, mats, dx, dt):
    """Host-side per-voxel coefficient maps from the thermal material list."""
    idx = np.asarray(mat_idx)
    rho = np.asarray(mats.density, np.float64)[idx]
    cp = np.asarray(mats.specific_heat, np.float64)[idx]
    kth = np.asarray(mats.conductivity, np.float64)[idx]
    w = np.asarray(mats.perfusion, np.float64)[idx]  # mL/min/kg

    inv_rho_cp = 1.0 / (rho * cp)
    # perfusion rate (1/s): mL/min/kg * rho[kg/m3] -> mL/min/m3 -> m3/s/m3
    omega = w * rho / (60.0 * 1e6)
    perf = omega * BLOOD_DENSITY * BLOOD_SPECIFIC_HEAT * inv_rho_cp * dt

    diff = kth  # conductivity map; interface averaging at run time
    return {
        "inv_rho_cp_dt": (inv_rho_cp * dt).astype(np.float32),
        "k": diff.astype(np.float32),
        "perf_dt": perf.astype(np.float32),
        "inv_dx2": np.float32(1.0 / dx**2),
    }


def absorption_heating(pressure, mat_idx, mats, duty_cycle=1.0):
    """Volumetric heat source Q (W/m^3) from a pressure amplitude map."""
    idx = np.asarray(mat_idx)
    rho = np.asarray(mats.density, np.float64)[idx]
    sos = np.asarray(mats.sos, np.float64)[idx]
    att = np.asarray(mats.attenuation, np.float64)[idx]
    absf = np.asarray(mats.absorption, np.float64)[idx]
    p = np.asarray(pressure, np.float64)
    return (absf * att * p**2 / (rho * sos) * duty_cycle).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("n_steps",))
def _bhte_scan(T0, dose0, Q_fields, field_sched, on_sched, coeff, monitor_idx, t_arterial, n_steps):
    kmap = coeff["k"]
    inv_dx2 = coeff["inv_dx2"]
    inv_rho_cp_dt = coeff["inv_rho_cp_dt"]
    perf_dt = coeff["perf_dt"]

    kxp = _harmonic_mean(kmap, _shift(kmap, 1, 0))
    kxm = _harmonic_mean(kmap, _shift(kmap, -1, 0))
    kyp = _harmonic_mean(kmap, _shift(kmap, 1, 1))
    kym = _harmonic_mean(kmap, _shift(kmap, -1, 1))
    kzp = _harmonic_mean(kmap, _shift(kmap, 1, 2))
    kzm = _harmonic_mean(kmap, _shift(kmap, -1, 2))

    dt_log2R_hi = jnp.float32(np.log2(0.5))
    dt_log2R_lo = jnp.float32(np.log2(0.25))

    def step(carry, xs):
        T, dose, peak = carry
        f_idx, on = xs
        lap = (
            kxp * (_shift(T, 1, 0) - T)
            + kxm * (_shift(T, -1, 0) - T)
            + kyp * (_shift(T, 1, 1) - T)
            + kym * (_shift(T, -1, 1) - T)
            + kzp * (_shift(T, 1, 2) - T)
            + kzm * (_shift(T, -1, 2) - T)
        ) * inv_dx2
        Q = jax.lax.dynamic_index_in_dim(Q_fields, f_idx, 0, keepdims=False)
        T_new = (
            T
            + lap * inv_rho_cp_dt
            + perf_dt * (t_arterial - T)
            + Q * inv_rho_cp_dt * on.astype(jnp.float32)
        )
        # CEM43 increment R^(43-T) = 2^(log2(R) * (43-T)); dt applied after scan
        R_log2 = jnp.where(T_new >= 43.0, dt_log2R_hi, dt_log2R_lo)
        dose_new = dose + jnp.exp2(R_log2 * (43.0 - T_new))
        peak_new = jnp.maximum(peak, T_new)
        mon = T_new.reshape(-1)[monitor_idx]
        return (T_new, dose_new, peak_new), mon

    (T, dose, peak), mons = jax.lax.scan(
        step, (T0, dose0, jnp.full_like(T0, -1e9)), (field_sched, on_sched), length=n_steps
    )
    return T, dose, peak, mons


def bhte_run(
    pressure_fields,
    mat_idx,
    mats,
    dx: float,
    schedule,
    *,
    dt: float = 0.01,
    duty_cycle: float = 1.0,
    monitor_points=None,
    initial_temperature=None,
    initial_dose=None,
    arterial_temperature: float | None = None,
    dose_dt_scale: float = 1.0,
) -> BHTEResult:
    """Run a BHTE schedule.

    Parameters
    ----------
    pressure_fields : (F, N1, N2, N3) or (N1, N2, N3) pressure amplitude maps
        (Pa). Multiple fields model time-multiplexed multipoint steering
        (`CalculateTemperatureEffects.py:711-736`).
    schedule : sequence of (field_index, n_steps, on) tuples executed in
        order; ``field_index < 0`` or ``on=False`` means no heating.
    duty_cycle : scales Q during 'on' phases (single-field path).
    monitor_points : (K, 3) integer voxel indices to record.

    Returns BHTEResult; dose is CEM43 in seconds; ``monitor_steps`` gives
    the global step index of each monitor sample.
    """
    p = np.asarray(pressure_fields, np.float32)
    if p.ndim == 3:
        p = p[None]
    F = p.shape[0]
    shape = p.shape[1:]

    Q = np.stack(
        [absorption_heating(p[f], mat_idx, mats, duty_cycle) for f in range(F)]
        + [np.zeros(shape, np.float32)]
    )  # last entry = zero field for 'off'

    field_sched = []
    on_sched = []
    for f_idx, n_steps, on in schedule:
        use = F if (not on or f_idx < 0) else int(f_idx)
        field_sched += [use] * int(n_steps)
        on_sched += [bool(on) and f_idx >= 0] * int(n_steps)
    field_sched = np.asarray(field_sched, np.int32)
    on_sched = np.asarray(on_sched, np.bool_)
    n_total = len(field_sched)

    coeff = {k: jnp.asarray(v) for k, v in _build_coeff_maps(mat_idx, mats, dx, dt).items()}

    t_init = np.asarray(mats.init_temperature, np.float64)[np.asarray(mat_idx)]
    T0 = jnp.asarray(
        initial_temperature if initial_temperature is not None else t_init, jnp.float32
    )
    dose0 = jnp.asarray(
        (np.asarray(initial_dose) / (dt * dose_dt_scale))
        if initial_dose is not None
        else np.zeros(shape),
        jnp.float32,
    )
    if monitor_points is None:
        monitor_points = np.zeros((1, 3), np.int64)
    mp = np.asarray(monitor_points)
    flat_idx = np.ravel_multi_index((mp[:, 0], mp[:, 1], mp[:, 2]), shape)

    t_art = float(
        arterial_temperature
        if arterial_temperature is not None
        else np.asarray(mats.init_temperature).max()
    )

    # CEM43 accumulation: dose += dt * R^(43-T); fold dt into post-scaling
    T, dose, peak, mons = _bhte_scan(
        T0,
        dose0,
        jnp.asarray(Q),
        jnp.asarray(field_sched),
        jnp.asarray(on_sched),
        coeff,
        jnp.asarray(flat_idx),
        jnp.float32(t_art),
        n_total,
    )
    return BHTEResult(
        temperature=np.asarray(T),
        peak_temperature=np.asarray(peak),
        dose=np.asarray(dose) * dt * dose_dt_scale,
        monitor=np.asarray(mons).T,
        monitor_steps=np.arange(n_total),
    )


def cem43(T_history_dt, temperatures):
    """Reference CEM43 for a temperature time series (seconds)."""
    T = np.asarray(temperatures, np.float64)
    R = np.where(T >= 43.0, 0.5, 0.25)
    return float(np.sum(T_history_dt * R ** (43.0 - T)))
