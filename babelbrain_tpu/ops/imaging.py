"""Volume image-processing ops (JAX equivalents of the reference's GPU kernels).

The reference ships six C kernels compiled for 4 GPU backends
(`BabelBrain/GPUFunctions/`, SURVEY.md section 2.3). Their XLA-native
equivalents:

  * median_filter3d     <- GPUMedianFilter (3-D median, reflect boundary)
  * binary_close        <- GPUBinaryClosing (dilate+erode, rect structure)
  * label_components    <- GPULabel (connected components, 6-connectivity)
  * map_to_unique       <- GPUMapping (value -> index in quantized table)
  * resample_affine / resample_from_to <- GPUResample (affine resample,
    orders 0/1/3; order 3 = cubic B-spline with host-side prefilter and
    on-device interpolation)
  * voxelization lives in ops/voxelize.py (host-side scanline prepass)

The reference chunks volumes through limited GPU memory
(`GPUUtils.py:23-82`); here chunking is only used to bound the median
filter's window-stack temporaries.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# median filter
# ---------------------------------------------------------------------------


def _reflect_pad(x, r):
    # scipy.ndimage 'reflect' == numpy 'symmetric' (edge value repeats)
    return jnp.pad(x, [(r, r)] * x.ndim, mode="symmetric")


@functools.partial(jax.jit, static_argnames=("size", "z_chunk"))
def _median3d(vol, size, z_chunk):
    r = size // 2
    padded = _reflect_pad(vol, r)
    n3 = vol.shape[2]

    def do_chunk(z0):
        # chunk of padded volume covering [z0, z0+z_chunk) of the output
        sub = jax.lax.dynamic_slice(
            padded,
            (0, 0, z0),
            (padded.shape[0], padded.shape[1], z_chunk + 2 * r),
        )
        windows = [
            sub[i : i + vol.shape[0], j : j + vol.shape[1], k : k + z_chunk]
            for i in range(size)
            for j in range(size)
            for k in range(size)
        ]
        stack = jnp.stack(windows, axis=-1)
        return jnp.median(stack, axis=-1)

    n_chunks = -(-n3 // z_chunk)
    outs = jax.lax.map(
        do_chunk, jnp.arange(n_chunks, dtype=jnp.int32) * z_chunk
    )
    out = jnp.moveaxis(outs, 0, 2).reshape(
        vol.shape[0], vol.shape[1], n_chunks * z_chunk
    )
    return out[:, :, :n3]


def median_filter3d(volume, size: int = 7, z_chunk: int = 8):
    """3-D median filter with reflect boundary (odd ``size`` <= 7).

    Matches `GPUFunctions/GPUMedianFilter/median_filter.cpp` behavior.
    """
    if size % 2 != 1:
        raise ValueError("size must be odd")
    vol = jnp.asarray(volume)
    n3 = vol.shape[2]
    z_chunk = min(z_chunk, n3)
    # pad z so chunks divide evenly; excess is cropped after (symmetric so
    # the true-edge windows still see scipy-'reflect' values)
    pad3 = (-n3) % z_chunk
    if pad3:
        vol = jnp.pad(vol, [(0, 0), (0, 0), (0, pad3)], mode="symmetric")
    out = _median3d(vol, size, z_chunk)
    return np.asarray(out[:, :, :n3])


# ---------------------------------------------------------------------------
# binary morphology
# ---------------------------------------------------------------------------


def _dilate(x, size):
    # outside-of-volume treated as background (scipy border_value=0)
    r = size // 2
    xp = jnp.pad(x, [(r, r)] * 3)
    return jax.lax.reduce_window(
        xp, -jnp.inf, jax.lax.max, (size, size, size), (1, 1, 1), "VALID"
    )


def _erode(x, size):
    r = size // 2
    xp = jnp.pad(x, [(r, r)] * 3)  # zeros: border counts as background
    return -jax.lax.reduce_window(
        -xp, -jnp.inf, jax.lax.max, (size, size, size), (1, 1, 1), "VALID"
    )


@functools.partial(jax.jit, static_argnames=("size",))
def _binary_close(vol, size):
    x = vol.astype(jnp.float32)
    return (_erode(_dilate(x, size), size) > 0.5).astype(jnp.uint8)


def binary_close(volume, size: int = 5):
    """Morphological closing with a cubic structuring element
    (`GPUBinaryClosing/binary_closing.cpp` equivalent). Boundary treated as
    background for the erosion (same as zero-padded closing)."""
    return np.asarray(_binary_close(jnp.asarray(volume), size)).astype(bool)


def binary_open(volume, size: int = 5):
    x = jnp.asarray(volume).astype(jnp.float32)
    return np.asarray(
        (_dilate(_erode(x, size), size) > 0.5).astype(jnp.uint8)
    ).astype(bool)


def binary_dilate(volume, size: int = 3):
    x = jnp.asarray(volume).astype(jnp.float32)
    return np.asarray(_dilate(x, size) > 0.5).astype(bool)


def binary_erode(volume, size: int = 3):
    x = jnp.asarray(volume).astype(jnp.float32)
    return np.asarray(_erode(x, size) > 0.5).astype(bool)


# ---------------------------------------------------------------------------
# connected components (6-connectivity)
# ---------------------------------------------------------------------------


@jax.jit
def _label_components(mask):
    shape = mask.shape
    n = mask.size
    flat_ids = jnp.arange(n, dtype=jnp.int32).reshape(shape)
    INF = jnp.int32(n)
    labels = jnp.where(mask, flat_ids, INF)

    def neighbor_min(lab):
        m = lab
        for axis in range(3):
            for shift in (-1, 1):
                nb = jnp.roll(lab, shift, axis)
                # kill wrap-around
                idx = [slice(None)] * 3
                idx[axis] = 0 if shift == 1 else -1
                nb = nb.at[tuple(idx)].set(INF)
                m = jnp.minimum(m, nb)
        return jnp.where(mask, m, INF)

    def compress(lab):
        # pointer jumping: label <- label[label]
        flat = lab.reshape(-1)
        safe = jnp.clip(flat, 0, n - 1)
        jumped = jnp.where(flat < n, flat[safe], INF)
        return jumped.reshape(shape)

    def body(state):
        lab, _ = state
        new = neighbor_min(lab)
        new = compress(compress(new))
        changed = jnp.any(new != lab)
        return new, changed

    def cond(state):
        return state[1]

    labels, _ = jax.lax.while_loop(cond, body, (labels, jnp.bool_(True)))
    return labels


def label_components(mask):
    """6-connected component labeling.

    Returns (labels int32 with 0 = background and 1..K compact component ids,
    K). Algorithm: iterative min-neighbor propagation with pointer-jumping
    compression (O(log diameter) sweeps) — the XLA replacement for the
    reference's `GPULabel/label.cpp` iterative kernels.
    """
    m = np.asarray(mask).astype(bool)
    raw = np.asarray(_label_components(jnp.asarray(m)))
    out = np.zeros(m.shape, np.int32)
    vals = raw[m]
    uniq, inv = np.unique(vals, return_inverse=True)
    out[m] = inv + 1
    return out, len(uniq)


def largest_component(mask):
    """Keep only the largest 6-connected component (common Step-1 cleanup,
    `BabelDatasetPreps.py:887-894`)."""
    labels, k = label_components(mask)
    if k == 0:
        return np.zeros_like(np.asarray(mask), bool)
    counts = np.bincount(labels.ravel())[1:]
    return labels == (int(np.argmax(counts)) + 1)


# ---------------------------------------------------------------------------
# value -> quantized-table index
# ---------------------------------------------------------------------------


def map_to_unique(volume, unique_values, mask=None):
    """Index of each voxel's value in the sorted ``unique_values`` table
    (`GPUMapping/map_filter.cpp` equivalent; nearest match)."""
    uv = jnp.asarray(unique_values)
    v = jnp.asarray(volume)
    idx = jnp.clip(jnp.searchsorted(uv, v), 0, len(np.asarray(unique_values)) - 1)
    # snap to nearest of idx / idx-1
    lo = jnp.clip(idx - 1, 0, None)
    pick_lo = jnp.abs(v - uv[lo]) <= jnp.abs(uv[idx] - v)
    out = jnp.where(pick_lo, lo, idx).astype(jnp.uint32)
    if mask is not None:
        out = jnp.where(jnp.asarray(mask), out, 0)
    return np.asarray(out)


# voxel coordinates reach ~300: a TF32 product (10-bit mantissa) would
# misplace samples by 0.1-0.3 voxel on a GPU
_HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# affine resampling
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("order", "out_shape"))
def _resample(vol, matrix, offset, out_shape, order):
    ii, jj, kk = jnp.meshgrid(
        jnp.arange(out_shape[0], dtype=jnp.float32),
        jnp.arange(out_shape[1], dtype=jnp.float32),
        jnp.arange(out_shape[2], dtype=jnp.float32),
        indexing="ij",
    )
    coords = jnp.stack([ii.ravel(), jj.ravel(), kk.ravel()])
    src = jnp.dot(matrix, coords, precision=_HIGHEST) + offset[:, None]
    from jax.scipy.ndimage import map_coordinates

    out = map_coordinates(vol, [src[0], src[1], src[2]], order=order, mode="constant")
    return out.reshape(out_shape)


def _bspline3_weights(t):
    """Cubic B-spline basis weights for fractional offset t in [0,1)."""
    t2 = t * t
    t3 = t2 * t
    w0 = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0
    w2 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0
    w3 = t3 / 6.0
    return (w0, w1, w2, w3)


@functools.partial(jax.jit, static_argnames=("out_shape",))
def _resample_cubic(coeff, matrix, offset, out_shape):
    """Cubic B-spline interpolation of prefiltered coefficients (zero
    outside, like scipy 'grid-constant')."""
    n1, n2, n3 = coeff.shape
    ii, jj, kk = jnp.meshgrid(
        jnp.arange(out_shape[0], dtype=jnp.float32),
        jnp.arange(out_shape[1], dtype=jnp.float32),
        jnp.arange(out_shape[2], dtype=jnp.float32),
        indexing="ij",
    )
    coords = jnp.stack([ii.ravel(), jj.ravel(), kk.ravel()])
    src = jnp.dot(matrix, coords, precision=_HIGHEST) + offset[:, None]

    base = jnp.floor(src).astype(jnp.int32)  # (3, P)
    frac = src - base
    wx = _bspline3_weights(frac[0])
    wy = _bspline3_weights(frac[1])
    wz = _bspline3_weights(frac[2])

    out = jnp.zeros(coords.shape[1], jnp.float32)
    dims = jnp.array([n1, n2, n3])
    for a in range(4):
        ix = base[0] + (a - 1)
        okx = (ix >= 0) & (ix < n1)
        cx = jnp.clip(ix, 0, n1 - 1)
        for b in range(4):
            iy = base[1] + (b - 1)
            oky = (iy >= 0) & (iy < n2)
            cy = jnp.clip(iy, 0, n2 - 1)
            for c in range(4):
                iz = base[2] + (c - 1)
                okz = (iz >= 0) & (iz < n3)
                cz = jnp.clip(iz, 0, n3 - 1)
                w = wx[a] * wy[b] * wz[c] * (okx & oky & okz)
                out = out + w * coeff[cx, cy, cz]
    return out.reshape(out_shape)


def resample_affine(volume, matrix, offset, out_shape, order: int = 1):
    """Resample with out_voxel -> in_voxel affine (scipy.ndimage convention).

    Orders 0 (nearest), 1 (linear), and 3 (cubic B-spline with prefilter) —
    the same set the reference's GPUResample exposes
    (`GPUResample/affine_transform.cpp` + `spline_filter.cpp`). Order 3
    prefilters host-side and interpolates on-device.
    """
    if order == 3:
        import scipy.ndimage as _ndi

        # zero-pad before prefiltering so boundary coefficients blend with
        # the outside value, matching scipy's 'grid-constant' handling
        PAD = 8
        padded = np.pad(np.asarray(volume, np.float32), PAD)
        coeff = _ndi.spline_filter(padded, order=3, output=np.float32)
        mat = np.asarray(matrix, np.float64)
        off = np.asarray(offset, np.float64) + PAD
        return np.asarray(
            _resample_cubic(
                jnp.asarray(coeff),
                jnp.asarray(mat, jnp.float32),
                jnp.asarray(off, jnp.float32),
                tuple(out_shape),
            )
        )
    return np.asarray(
        _resample(
            jnp.asarray(volume, jnp.float32),
            jnp.asarray(matrix, jnp.float32),
            jnp.asarray(offset, jnp.float32),
            tuple(out_shape),
            order,
        )
    )


def resample_from_to(volume, from_affine, to_affine, to_shape, order: int = 1):
    """nibabel ``resample_from_to`` equivalent (`Resample.py` contract):
    resample ``volume`` (voxel->world ``from_affine``) onto the grid defined
    by (``to_shape``, ``to_affine``)."""
    M = np.linalg.inv(from_affine) @ to_affine
    return resample_affine(volume, M[:3, :3], M[:3, 3], to_shape, order)
