"""The XLA FDTD scan against a float64 NumPy stepper written from the
equations.

The reference stepper shares only the per-material SLS coefficient tuning
(``sls_coefficients``, host-side float64) with the code under test. The
staggered 4th-order derivatives, the CPML recursion (here on full-size psi
arrays instead of boundary slabs), the source injection, the relaxation
memory update and the carrier DFT are all written out again below, so a
change to the device step shows up as a disagreement with the equations
and not only with a stored golden.
"""

import numpy as np
import pytest

from babelbrain_tpu.ops.fdtd import FDTDGrid, run_fdtd, sls_coefficients, stable_dt

F0 = 500e3
NPML = 4
C1, C2 = 9.0 / 8.0, -1.0 / 24.0


def _shift(f, o, ax):
    """out[i] = f[i + o] along ``ax``, zero outside."""
    out = np.zeros_like(f)
    n = f.shape[ax]
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    if o >= 0:
        src[ax], dst[ax] = slice(o, n), slice(0, n - o)
    else:
        src[ax], dst[ax] = slice(0, n + o), slice(-o, n)
    out[tuple(dst)] = f[tuple(src)]
    return out


def _dp(f, ax):  # derivative at i+1/2 from integer samples
    return C1 * (_shift(f, 1, ax) - f) + C2 * (_shift(f, 2, ax) - _shift(f, -1, ax))


def _dm(f, ax):  # derivative at i from half samples
    return C1 * (f - _shift(f, -1, ax)) + C2 * (_shift(f, 1, ax) - _shift(f, -2, ax))


def _cpml_ab(n, dx, dt, cmax, half, R=1e-5, m=3.0):
    """Roden-Gedney CPML (b, a) along one axis (kappa=1, alpha=0)."""
    L = NPML * dx
    smax = -(m + 1.0) * cmax * np.log(R) / (2.0 * L)
    x = np.arange(n) + (0.5 if half else 0.0)
    d = (np.clip(NPML - x, 0, NPML) / NPML) ** m + (
        np.clip(x - (n - 1 - NPML), 0, NPML) / NPML) ** m
    sig = smax * d
    b = np.exp(-sig * dt)
    return b, np.where(sig > 0, b - 1.0, 0.0)


class _Reference:
    def __init__(self, grid, idx, mats, amp2, ph2, point_amp, vol):
        self.g = grid
        m = np.asarray(mats, np.float64)
        co = sls_coefficients(m, grid.frequency, grid.dt)
        self.shear = bool(np.any(m[:, 2] > 0))
        self.viscous = co["viscous"]
        self.p = {k: np.asarray(co[k], np.float64)[idx]
                  for k in ("pi_u", "mu_u", "c_rp", "c_rs", "b_r", "rho_inv")}
        self.oz = 1.0 / (m[0, 0] * m[0, 1])
        cmax = max(m[:, 1].max(), m[:, 2].max())
        self.ab = {}
        for ax in range(3):
            for half in (False, True):
                b, a = _cpml_ab(grid.shape[ax], grid.dx, grid.dt, cmax, half)
                sh = [1, 1, 1]
                sh[ax] = -1
                self.ab[ax, half] = (b.reshape(sh), a.reshape(sh))
        self.psi = {}
        self.amp2, self.ph2 = amp2, ph2
        self.point_amp, self.vol = point_amp, vol

    def deriv(self, name, f, ax, plus):
        """CPML-corrected derivative; psi memory keyed by ``name``."""
        d = _dp(f, ax) if plus else _dm(f, ax)
        b, a = self.ab[ax, plus]
        psi = b * self.psi.get(name, 0.0) + a * d
        self.psi[name] = psi
        return d + psi

    def run(self):
        g, p = self.g, self.p
        z = lambda: np.zeros(g.shape)
        names = (("vx", "vy", "vz", "sxx", "syy", "szz", "sxy", "sxz", "syz",
                  "rxx", "ryy", "rzz", "rxy", "rxz", "ryz")
                 if self.shear else ("vx", "vy", "vz", "p", "r"))
        f = {k: z() for k in names}
        acc_c, acc_s, peak = z(), z(), z()
        w = 2 * np.pi * g.frequency
        k = g.dt / g.dx
        ramp_steps = g.ramp_cycles / g.frequency / g.dt
        for n in range(g.n_steps):
            t = n * g.dt
            ramp = 0.5 * (1 - np.cos(np.pi * n / ramp_steps)) if n < ramp_steps else 1.0
            if self.shear:
                f["vx"] += k * p["rho_inv"] * (
                    self.deriv("sxx_x", f["sxx"], 0, True)
                    + self.deriv("sxy_y", f["sxy"], 1, False)
                    + self.deriv("sxz_z", f["sxz"], 2, False))
                f["vy"] += k * p["rho_inv"] * (
                    self.deriv("sxy_x", f["sxy"], 0, False)
                    + self.deriv("syy_y", f["syy"], 1, True)
                    + self.deriv("syz_z", f["syz"], 2, False))
                f["vz"] += k * p["rho_inv"] * (
                    self.deriv("sxz_x", f["sxz"], 0, False)
                    + self.deriv("syz_y", f["syz"], 1, False)
                    + self.deriv("szz_z", f["szz"], 2, True))
            else:
                for ax, v in enumerate(("vx", "vy", "vz")):
                    f[v] -= k * p["rho_inv"] * self.deriv(
                        "p" + v, f["p"], ax, True)
            self.inject_velocity(f, w * t, ramp)
            dii = [self.deriv(v + "_d", f[v], ax, False)
                   for ax, v in enumerate(("vx", "vy", "vz"))]
            theta = sum(dii)
            if self.shear:
                for s, r, d in zip(("sxx", "syy", "szz"), ("rxx", "ryy", "rzz"), dii):
                    dev = theta - d
                    inc = k * (p["pi_u"] * theta - 2 * p["mu_u"] * dev)
                    if self.viscous:
                        new_r = p["b_r"] * f[r] - (
                            p["c_rp"] * theta - 2 * p["c_rs"] * dev) / g.dx
                        inc = inc + g.dt * 0.5 * (new_r + f[r])
                        f[r] = new_r
                    f[s] += inc
                pairs = (("sxy", "rxy", ("vx", 1), ("vy", 0)),
                         ("sxz", "rxz", ("vx", 2), ("vz", 0)),
                         ("syz", "ryz", ("vy", 2), ("vz", 1)))
                for s, r, (va, aa), (vb, ab) in pairs:
                    e = (self.deriv(s + "a", f[va], aa, True)
                         + self.deriv(s + "b", f[vb], ab, True))
                    inc = k * p["mu_u"] * e
                    if self.viscous:
                        new_r = p["b_r"] * f[r] - p["c_rs"] * e / g.dx
                        inc = inc + g.dt * 0.5 * (new_r + f[r])
                        f[r] = new_r
                    f[s] += inc
            else:
                inc = k * p["pi_u"] * theta
                if self.viscous:
                    new_r = p["b_r"] * f["r"] - p["c_rp"] * theta / g.dx
                    inc = inc + g.dt * 0.5 * (new_r + f["r"])
                    f["r"] = new_r
                f["p"] -= inc
            if g.source_type == "stress_point":
                sval = self.point_amp * np.sin(w * t) * ramp
                if self.shear:
                    for s in ("sxx", "syy", "szz"):
                        f[s][g.source_ijk] += sval
                else:
                    f["p"][g.source_ijk] -= sval
            pr = (-(f["sxx"] + f["syy"] + f["szz"]) / 3.0 if self.shear
                  else f["p"])
            if n >= g.sensor_start:
                acc_c += pr * np.cos(w * t)
                acc_s += pr * np.sin(w * t)
                peak = np.maximum(peak, np.abs(pr))
        n_win = g.n_steps - g.sensor_start
        return 2.0 / n_win * np.hypot(acc_c, acc_s), peak

    def inject_velocity(self, f, wt, ramp):
        g = self.g
        if g.source_type == "velocity_plane":
            sval = self.amp2 * np.sin(wt + self.ph2) * ramp * self.oz
            zs = g.source_plane_z
            f["vz"][:, :, zs] = np.where(self.amp2 > 0, sval, f["vz"][:, :, zs])
        elif g.source_type == "velocity_volume":
            v = self.vol
            sv = v["amp"] * np.sin(wt + v["phase"]) * ramp * self.oz
            on = v["amp"] > 0
            for c, o in (("vx", "ox"), ("vy", "oy"), ("vz", "oz")):
                f[c] = np.where(on, sv * v[o], f[c])


WATER = [1000.0, 1500.0, 0.0, 2.0, 0.0]
SKULL_FLUID = [1850.0, 2800.0, 0.0, 150.0, 0.0]
SKULL_SHEAR = [1896.5, 2494.0, 1594.0, 106.0, 214.0]


def _case(kind):
    shape = (22, 20, 36)
    shear = kind in ("shear", "stress_point")
    mats = np.array([WATER, SKULL_SHEAR if shear else SKULL_FLUID])
    dx = 1500.0 / F0 / 6
    ppp = int(np.ceil(1 / F0 / stable_dt(dx, mats[:, 1:3].max(), cfl=0.6)))
    dt = 1 / F0 / ppp
    n_steps = 3 * ppp
    src = {"fluid": "velocity_plane", "shear": "velocity_plane"}.get(kind, kind)
    grid = FDTDGrid(
        shape=shape, dx=dx, dt=dt, n_steps=n_steps, frequency=F0, npml=NPML,
        sensor_start=n_steps - ppp, source_plane_z=NPML + 2,
        source_type=src, source_ijk=(11, 9, 16), ramp_cycles=1.0,
    )
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 18:22] = 1
    rng = np.random.default_rng(3)
    amp2 = np.zeros(shape[:2])
    amp2[6:-6, 6:-6] = 60e3 * rng.uniform(0.5, 1.0, (10, 8))
    ph2 = rng.uniform(-2, 2, shape[:2])
    vol = None
    if kind == "velocity_volume":
        ii, jj, kk = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
        r = np.sqrt((ii - 11.0) ** 2 + (jj - 10.0) ** 2 + (kk - 16.0) ** 2)
        shell = (r > 5) & (r < 6.5) & (kk < 14)
        rr = np.maximum(r, 1e-6)
        vol = dict(amp=np.where(shell, 60e3, 0.0),
                   phase=rng.uniform(-2, 2, shape) * shell,
                   ox=(11.0 - ii) / rr, oy=(10.0 - jj) / rr, oz=(16.0 - kk) / rr)
    return grid, idx, mats, amp2, ph2, 2e5, vol


@pytest.mark.parametrize(
    "kind", ["fluid", "shear", "velocity_volume", "stress_point"]
)
def test_xla_scan_matches_float64_reference(kind):
    grid, idx, mats, amp2, ph2, point_amp, vol = _case(kind)
    amp_ref, peak_ref = _Reference(
        grid, idx, mats, amp2, ph2, point_amp, vol).run()
    kw = dict(point_amp=point_amp) if kind == "stress_point" else dict(
        source_amp=amp2, source_phase=ph2)
    if vol is not None:
        kw = dict(volume_source={k: np.asarray(v, np.float32)
                                 for k, v in vol.items()})
    out = run_fdtd(idx, mats, grid, **kw)
    scale = amp_ref.max()
    assert scale > 0 and np.isfinite(out["p_amp"]).all()
    rel_l2 = np.linalg.norm(out["p_amp"] - amp_ref) / np.linalg.norm(amp_ref)
    rel_inf = np.abs(out["p_amp"] - amp_ref).max() / scale
    # float32 device arithmetic vs float64 reaches ~2e-7 over ~100 steps
    # on the CPU; a 1% error in one stencil coefficient gives ~1.5e-3
    assert rel_l2 < 1e-5, rel_l2
    assert rel_inf < 1e-5, rel_inf
    np.testing.assert_allclose(out["peak"], peak_ref, rtol=0,
                               atol=1e-5 * peak_ref.max())
