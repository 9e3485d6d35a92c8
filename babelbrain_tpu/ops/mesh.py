"""Iso-surface extraction, mesh smoothing, and mesh booleans (host ops).

Covers the reference's mesh toolchain for Step 1 (SURVEY.md section 2.2):
`MaskToStl` (`BabelBrain/BabelDatasetPreps.py:87` — vtk marching cubes +
`smooth` `:71`) and the cone/box FOV intersection `DoIntersect`
(`BabelDatasetPreps.py:264`, manifold3d/Blender boolean). These run on the
host: meshing is an irregular one-shot preprocessing op (milliseconds on
the volumes involved), while the resulting grids are what the device consumes.

Design notes
------------
* Iso-surface extraction uses **marching tetrahedra** (each cell split into
  6 tetrahedra sharing the main diagonal). Unlike classic marching cubes it
  has no ambiguous cases, so the surface is watertight by construction —
  which the downstream solid voxelizer (`ops.voxelize`) requires.
* Smoothing is **Taubin lambda/mu** (non-shrinking Laplacian), the standard
  replacement for vtk's windowed-sinc `smooth()` used by the reference.
* The mesh boolean is voxel-based: solid-voxelize both operands on a common
  grid, combine, and re-extract the surface. The reference reaches for
  manifold3d (or a Blender subprocess) for exact booleans; a voxel boolean
  at the simulation resolution is equivalent for FOV trimming because the
  result is immediately re-voxelized anyway.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "marching_tetrahedra",
    "weld_vertices",
    "taubin_smooth",
    "mask_to_mesh",
    "mesh_volume",
    "faces_to_triangles",
    "boolean_meshes",
    "cone_mesh",
]

# cube corner offsets (i, j, k) and the 6-tetrahedra decomposition sharing
# the 0-6 main diagonal (a standard split; every face diagonal is shared
# consistently between neighbouring cells, giving a crack-free surface)
_CUBE = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    np.int64,
)
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int64,
)


def _interp(p0, v0, p1, v1, level):
    t = (level - v0) / (v1 - v0)
    return p0 + t[:, None] * (p1 - p0)


def _orient(tris, inside_pt):
    """Flip triangles so the normal points away from the inside point."""
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    ref = tris.mean(1) - inside_pt
    flip = np.einsum("ij,ij->i", n, ref) < 0
    tris[flip] = tris[flip][:, ::-1]
    return tris


def marching_tetrahedra(volume: np.ndarray, level: float = 0.5) -> np.ndarray:
    """Extract the iso-surface of a scalar volume as (T, 3, 3) triangles.

    Vertices are in voxel index coordinates (apply an affine afterwards).
    The surface is closed whenever the iso-surface does not touch the
    volume boundary, and triangles are oriented with outward normals
    (outward = away from the ``volume > level`` region).
    """
    vol = np.asarray(volume, np.float64)
    if vol.ndim != 3:
        raise ValueError("volume must be 3-D")

    # active cells: 2x2x2 block straddles the level
    c = [vol[o[0] : vol.shape[0] - 1 + o[0],
             o[1] : vol.shape[1] - 1 + o[1],
             o[2] : vol.shape[2] - 1 + o[2]] for o in _CUBE]
    stack = np.stack(c, axis=-1)  # (n1-1, n2-1, n3-1, 8)
    active = (stack.min(-1) < level) & (stack.max(-1) > level)
    idx = np.argwhere(active)
    if len(idx) == 0:
        return np.zeros((0, 3, 3), np.float64)
    vals8 = stack[active]  # (C, 8)
    pos8 = idx[:, None, :] + _CUBE[None, :, :]  # (C, 8, 3)

    out = []
    for tet in _TETS:
        v = vals8[:, tet]  # (C, 4)
        p = pos8[:, tet].astype(np.float64)  # (C, 4, 3)
        ins = v > level
        n_in = ins.sum(1)
        # stable partition: inside vertices first, preserving order
        order = np.argsort(~ins, axis=1, kind="stable")
        vo = np.take_along_axis(v, order, 1)
        po = np.take_along_axis(p, order[..., None], 1)

        # one vertex on one side -> single triangle on the 3 edges from it
        for n_same, flipped in ((1, False), (3, True)):
            m = n_in == n_same
            if not m.any():
                continue
            if flipped:
                # 3 inside: apex is the single outside vertex (slot 3)
                vm = vo[m][:, [3, 0, 1, 2]]
                pm = po[m][:, [3, 0, 1, 2]]
                inside_pt = po[m][:, :3].mean(1)
            else:
                vm, pm = vo[m], po[m]
                inside_pt = po[m][:, 0]
            t = np.stack(
                [
                    _interp(pm[:, 0], vm[:, 0], pm[:, j], vm[:, j], level)
                    for j in (1, 2, 3)
                ],
                axis=1,
            )
            out.append(_orient(t, inside_pt))

        m = n_in == 2
        if m.any():
            vm, pm = vo[m], po[m]  # inside: slots 0,1; outside: slots 2,3
            e = {}
            for a, b in ((0, 2), (0, 3), (1, 2), (1, 3)):
                e[(a, b)] = _interp(pm[:, a], vm[:, a], pm[:, b], vm[:, b], level)
            # quad ring: (0,2) -> (0,3) -> (1,3) -> (1,2)
            inside_pt = pm[:, :2].mean(1)
            t1 = np.stack([e[(0, 2)], e[(0, 3)], e[(1, 3)]], 1)
            t2 = np.stack([e[(0, 2)], e[(1, 3)], e[(1, 2)]], 1)
            out.append(_orient(t1, inside_pt))
            out.append(_orient(t2, inside_pt))

    tris = np.concatenate(out, 0)
    # drop degenerate slivers (zero area)
    area2 = np.linalg.norm(
        np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=1
    )
    return tris[area2 > 1e-12]


def weld_vertices(triangles: np.ndarray, tol: float = 1e-6):
    """(T,3,3) triangle soup -> (verts (V,3), faces (F,3)) with dedup."""
    pts = np.asarray(triangles, np.float64).reshape(-1, 3)
    key = np.round(pts / tol).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    verts = pts[first]
    faces = inv.reshape(-1, 3)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[ok]


def taubin_smooth(
    verts: np.ndarray,
    faces: np.ndarray,
    iterations: int = 10,
    lam: float = 0.5,
    mu: float = -0.53,
) -> np.ndarray:
    """Taubin lambda|mu smoothing (volume-preserving Laplacian).

    Counterpart of the reference's `smooth()` (vtkWindowedSincPolyDataFilter,
    `BabelDatasetPreps.py:71-85`): relaxes the marching staircase without the
    shrinkage of plain Laplacian smoothing.
    """
    v = np.asarray(verts, np.float64).copy()
    f = np.asarray(faces)
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], 0)
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    deg = np.bincount(src, minlength=len(v)).astype(np.float64)
    deg = np.maximum(deg, 1.0)

    def laplace(x):
        acc = np.zeros_like(x)
        np.add.at(acc, src, x[dst])
        return acc / deg[:, None] - x

    for _ in range(iterations):
        v += lam * laplace(v)
        v += mu * laplace(v)
    return v


def faces_to_triangles(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    return np.asarray(verts, np.float64)[np.asarray(faces)]


def mesh_volume(triangles: np.ndarray) -> float:
    """Signed volume of a closed, outward-oriented triangle mesh."""
    t = np.asarray(triangles, np.float64)
    return float(np.einsum("ij,ij->i", t[:, 0], np.cross(t[:, 1], t[:, 2])).sum() / 6.0)


def mask_to_mesh(
    mask: np.ndarray,
    affine: np.ndarray | None = None,
    smooth_iterations: int = 10,
    presmooth: int = 1,
):
    """Binary mask -> smoothed surface triangles (world coords if affine given).

    The reference's `MaskToStl` (`BabelDatasetPreps.py:87-120`): binary label
    volume -> marching cubes -> windowed-sinc smooth -> STL. Returns
    (T, 3, 3) float64 triangles (write with `ops.voxelize.write_stl`).
    """
    field = np.asarray(mask, np.float64)
    # small box pre-blur reduces staircase before extraction; the surface is
    # then at the 0.5 crossing of the blurred indicator
    for _ in range(presmooth):
        acc = np.zeros_like(field)
        n = 0
        for ax in range(3):
            for sh in (-1, 1):
                acc += np.roll(field, sh, axis=ax)
                n += 1
        field = (acc + field) / (n + 1)
    # pad so surfaces at the volume edge still close
    field = np.pad(field, 1)
    tris = marching_tetrahedra(field, 0.5) - 1.0
    if smooth_iterations > 0 and len(tris):
        verts, faces = weld_vertices(tris)
        verts = taubin_smooth(verts, faces, smooth_iterations)
        tris = faces_to_triangles(verts, faces)
    if affine is not None:
        A = np.asarray(affine, np.float64)
        tris = tris @ A[:3, :3].T + A[:3, 3]
    return tris


def boolean_meshes(
    tris_a: np.ndarray,
    tris_b: np.ndarray,
    pitch: float,
    op: str = "intersection",
    smooth_iterations: int = 5,
) -> np.ndarray:
    """Voxel-based mesh boolean: AND/OR/DIFF of two watertight meshes.

    Counterpart of the reference's `DoIntersect` (`BabelDatasetPreps.py:264`,
    manifold3d with Blender fallback), used to trim the skin mesh to the
    transducer FOV cone. Both solids are voxelized at ``pitch`` on a common
    grid, combined, and re-meshed.
    """
    from .voxelize import voxelize_solid

    a = np.asarray(tris_a, np.float64).reshape(-1, 3)
    b = np.asarray(tris_b, np.float64).reshape(-1, 3)
    lo = np.minimum(a.min(0), b.min(0)) - 2 * pitch
    hi = np.maximum(a.max(0), b.max(0)) + 2 * pitch
    shape = tuple(np.ceil((hi - lo) / pitch).astype(int) + 1)
    va = voxelize_solid(tris_a, lo, pitch, shape)
    vb = voxelize_solid(tris_b, lo, pitch, shape)
    if op == "intersection":
        m = va & vb
    elif op == "union":
        m = va | vb
    elif op == "difference":
        m = va & ~vb
    else:
        raise ValueError(f"unknown op {op!r}")
    scale = np.eye(4)
    scale[:3, :3] *= pitch
    scale[:3, 3] = lo
    return mask_to_mesh(m, scale, smooth_iterations)


def cone_mesh(
    apex,
    direction,
    length: float,
    r_apex: float,
    r_base: float,
    n_seg: int = 64,
) -> np.ndarray:
    """Closed (truncated-)cone mesh along ``direction`` from ``apex``.

    The reference builds this FOV cone with trimesh around the trajectory
    (`BabelDatasetPreps.py:513-556`) and intersects it with the skin.
    """
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    u = np.array([1.0, 0, 0]) if abs(d[0]) < 0.9 else np.array([0, 1.0, 0])
    e1 = np.cross(d, u)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(d, e1)
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.cos(ang)[:, None] * e1 + np.sin(ang)[:, None] * e2
    apex = np.asarray(apex, np.float64)
    top = apex + max(r_apex, 1e-9) * ring
    bot = apex + length * d + r_base * ring
    ct, cb = apex, apex + length * d
    tris = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        tris += [
            [top[i], bot[i], bot[j]],
            [top[i], bot[j], top[j]],
            [ct, top[j], top[i]],  # top cap
            [cb, bot[i], bot[j]],  # bottom cap
        ]
    t = np.asarray(tris)
    # the solid is convex: orient every face outward from an interior point
    return _orient(t, (ct + cb) / 2.0)
