"""Rayleigh-Sommerfeld integral propagator (blocked matmul formulation).

Computes the monochromatic field radiated by M source patches at P field
points:

    p(x_p) = (i k / 2 pi) * sum_m  u0_m * ds_m * exp(-i k r_pm) / r_pm

with complex wavenumber ``k = 2 pi f / c + i alpha`` (imaginary part =
attenuation in Np/m). With ``u0`` in pressure units (rho c v), this
normalization reproduces the exact on-axis piston solution
``p(z) = u0 (e^{-ikz} - e^{-ikR})`` and is the contract of the reference's
``ForwardSimple`` (`TranscranialModeling/BabelIntegrationBASE.py:2180` call
sites; SURVEY.md section 2.9).

Formulation: the pair distances are computed with the expanded form
``r^2 = |p|^2 - 2 p.c + |c|^2`` so the O(M*P) inner product is a matmul,
and the complex kernel accumulation is four real matmuls over (re, im)
pairs. All matmuls use ``precision=HIGHEST``: a bf16 or TF32 product keeps
about three decimal digits and would put phase errors near 0.5 rad at
k*r ~ 1e3.
Field points are processed in blocks via ``lax.map`` and source patches via
an inner ``lax.scan``, so memory stays at O(block^2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_HIGH = jax.lax.Precision.HIGHEST


def _pad_to(x, n, axis=0):
    pad = n - x.shape[axis]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


@functools.partial(jax.jit, static_argnames=("point_block", "elem_block"))
def _rayleigh_blocks(kr, ki, centers, wds_re, wds_im, points, point_block, elem_block):
    """Core blocked evaluation. Returns (P_padded, 2) [re, im]."""
    M = centers.shape[0]
    P = points.shape[0]
    n_eb = -(-M // elem_block)
    n_pb = -(-P // point_block)

    c_pad = _pad_to(centers, n_eb * elem_block)
    # padded elements get zero weight -> no contribution
    w_re = _pad_to(wds_re, n_eb * elem_block)
    w_im = _pad_to(wds_im, n_eb * elem_block)
    # keep padded distances well-conditioned (nonzero)
    c_pad = c_pad.at[M:].set(jnp.array([10.0, 10.0, 10.0], c_pad.dtype))

    p_pad = _pad_to(points, n_pb * point_block)
    p_blocks = p_pad.reshape(n_pb, point_block, 3)

    c_blocks = c_pad.reshape(n_eb, elem_block, 3)
    w_blocks = jnp.stack(
        [w_re.reshape(n_eb, elem_block), w_im.reshape(n_eb, elem_block)], axis=-1
    )  # (n_eb, eb, 2)

    c_sq = jnp.sum(c_blocks * c_blocks, axis=-1)  # (n_eb, eb)

    def point_block_fn(pts):  # (pb, 3) -> (pb, 2)
        p_sq = jnp.sum(pts * pts, axis=-1)  # (pb,)

        def elem_step(acc, args):
            cb, cb_sq, wb = args
            dot = jnp.dot(pts, cb.T, precision=_HIGH)  # (pb, eb)
            r2 = jnp.maximum(p_sq[:, None] - 2.0 * dot + cb_sq[None, :], 1e-12)
            r = jnp.sqrt(r2)
            inv_r = 1.0 / r
            decay = jnp.exp(-ki * r) * inv_r
            phase = -kr * r
            a_re = decay * jnp.cos(phase)
            a_im = decay * jnp.sin(phase)
            # (a_re + i a_im) @ (w_re + i w_im)
            out_re = jnp.dot(a_re, wb[:, 0], precision=_HIGH) - jnp.dot(
                a_im, wb[:, 1], precision=_HIGH
            )
            out_im = jnp.dot(a_re, wb[:, 1], precision=_HIGH) + jnp.dot(
                a_im, wb[:, 0], precision=_HIGH
            )
            return acc + jnp.stack([out_re, out_im], axis=-1), None

        acc0 = jnp.zeros((pts.shape[0], 2), jnp.float32)
        acc, _ = jax.lax.scan(elem_step, acc0, (c_blocks, c_sq, w_blocks))
        return acc

    out = jax.lax.map(point_block_fn, p_blocks)  # (n_pb, pb, 2)
    return out.reshape(n_pb * point_block, 2)


def rayleigh_field(
    wavenumber: complex,
    centers,
    areas,
    u0,
    points,
    *,
    point_block: int = 8192,
    elem_block: int = 2048,
    mesh=None,
):
    """Evaluate the Rayleigh integral at ``points``.

    Parameters
    ----------
    wavenumber : complex
        k = 2 pi f / c + i alpha (alpha in Np/m).
    centers : (M, 3) source patch centers (m).
    areas : (M,) patch areas (m^2).
    u0 : (M,) complex surface pressure amplitudes (Pa).
    points : (P, 3) field points (m).
    mesh : optional 1-D ``jax.sharding.Mesh``: the field-point axis is
        sharded over its devices (each device integrates ALL sources over
        its point block — embarrassingly parallel, no collectives; SURVEY.md
        section 2.8 row 4 maps this as the S2 hot loop's sharding axis for
        dome/phased arrays where M x P ~ 1e5 x 1e7).

    Returns
    -------
    (P,) complex64 pressure field.
    """
    kr = float(np.real(wavenumber))
    ki = float(np.imag(wavenumber))
    # host-side prep in float64; the device evaluates the sum in float32
    # with the complex weights split into (re, im) planes
    centers = np.asarray(centers, np.float64)
    points = np.asarray(points, np.float64)
    u0 = np.asarray(u0, np.complex128).reshape(-1)
    areas = np.asarray(areas, np.float64).reshape(-1)

    # shift coordinates to the midpoint for f32 conditioning
    allpts = np.concatenate([centers, points])
    mid = (allpts.min(0) + allpts.max(0)) * 0.5
    centers = centers - mid
    points = points - mid

    # fold the (i k / 2 pi) prefactor and area weights into the source term
    pref = 1j * (kr + 1j * ki) / (2.0 * np.pi)
    w = u0 * areas * pref
    P = points.shape[0]
    if mesh is not None and mesh.devices.size > 1:
        from jax.sharding import PartitionSpec as PS

        axis = mesh.axis_names[0]
        n_dev = int(mesh.devices.size)
        p_pad = -(-P // n_dev) * n_dev
        pts = np.zeros((p_pad, 3), np.float32)
        pts[:P] = points
        local_block = min(point_block, p_pad // n_dev)
        fn = jax.jit(
            jax.shard_map(
                functools.partial(
                    _rayleigh_blocks,
                    point_block=local_block,
                    elem_block=elem_block,
                ),
                mesh=mesh,
                in_specs=(PS(), PS(), PS(), PS(), PS(), PS(axis, None)),
                out_specs=PS(axis, None),
                # the blocked scan carry starts unvarying; skip vma typing
                check_vma=False,
            )
        )
        out = fn(
            kr, ki,
            jnp.asarray(centers, jnp.float32),
            jnp.asarray(np.real(w), jnp.float32),
            jnp.asarray(np.imag(w), jnp.float32),
            jnp.asarray(pts),
        )
    else:
        out = _rayleigh_blocks(
            kr,
            ki,
            jnp.asarray(centers, jnp.float32),
            jnp.asarray(np.real(w), jnp.float32),
            jnp.asarray(np.imag(w), jnp.float32),
            jnp.asarray(points, jnp.float32),
            point_block,
            elem_block,
        )
    out = np.asarray(out[:P])
    return (out[:, 0] + 1j * out[:, 1]).astype(np.complex64)


def rayleigh_field_volume(wavenumber, tx, u0, x, y, z, **kw):
    """Evaluate on a full (len(x), len(y), len(z)) grid; returns complex64 volume.

    Grid layout matches the reference's meshgrid ordering
    (`BabelIntegrationSingle.py:290-297`).
    """
    xp, yp, zp = np.meshgrid(
        np.asarray(x), np.asarray(y), np.asarray(z), indexing="ij"
    )
    pts = np.stack([xp.ravel(), yp.ravel(), zp.ravel()], axis=1).astype(np.float32)
    field = rayleigh_field(wavenumber, tx.centers, tx.areas, u0, pts, **kw)
    return np.asarray(field).reshape(len(x), len(y), len(z))


def steering_phases(
    wavenumber: complex,
    elem_centers,
    target,
    spatial_step: float = 1e-3,
):
    """Conjugate-phase element programming toward ``target``.

    Backward-propagates a virtual point source at the steered target to the
    element centers and conjugates (`BabelIntegrationCONCAVE_PHASEDARRAY.py:292-314`).
    Returns complex per-element weights (unit-amplitude phases).
    """
    target = np.asarray(target, np.float32).reshape(1, 3)
    u_back = rayleigh_field(
        wavenumber,
        target,
        np.array([spatial_step**2], np.float32),
        np.array([1.0 + 0j], np.complex64),
        np.asarray(elem_centers, np.float32),
    )
    conj = np.conjugate(np.asarray(u_back))
    return np.exp(1j * np.angle(conj)).astype(np.complex64)


def expand_element_weights(tx, elem_weights):
    """Broadcast per-element complex weights to per-sub-element u0."""
    ew = np.asarray(elem_weights, np.complex64)
    return ew[np.asarray(tx.elem_ids)]
