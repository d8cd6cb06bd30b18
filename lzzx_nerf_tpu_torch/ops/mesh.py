"""Iso-surface extraction via marching tetrahedra (the port's copy of
lzzx_nerf_tpu/ops/mesh.py; numpy, dependency-free).

Replaces the reference's save_mesh path (TrainerUtil.py:444-465 +
utils.extract_geometry, which uses the `mcubes` package). Marching
tetrahedra needs no 256-entry case tables: each grid cell splits into 6
tetrahedra and each tet emits 0/1/2 triangles from its 16 sign cases,
enumerable with simple logic. Slightly more triangles than marching cubes,
same surface. The density queries run wherever `query_func` runs them (the
CLI's run_save_mesh: the head field on its device); the marcher runs on the
host.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

# standard 6-tet decomposition of a cube with corners indexed by bits (x,y,z):
# corner i has coords ((i>>2)&1, (i>>1)&1, i&1)
_TETS = np.array([
    [0, 7, 3, 1],
    [0, 7, 1, 5],
    [0, 7, 5, 4],
    [0, 7, 4, 6],
    [0, 7, 6, 2],
    [0, 7, 2, 3],
], dtype=np.int32)

_CORNERS = np.array([[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)],
                    dtype=np.float32)


def _orient_outward(tri, ref_in, ref_out):
    """tri: [m, 3, 3]; flip vertex order wherever the face normal does not
    point from the inside (v > iso) region toward the outside, so the whole
    surface winds consistently (counter-clockwise seen from outside — the
    orientation mcubes produces in the reference's save_mesh path)."""
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = ((ref_out - ref_in) * n).sum(-1) < 0
    tri[flip] = tri[flip][:, [0, 2, 1]]
    return tri


def _tet_triangles(p, v, iso):
    """p: [M, 4, 3] tet corner positions; v: [M, 4] values.
    Returns [K, 3, 3] triangles crossing the iso level, consistently wound."""
    inside = v > iso                                    # [M, 4]
    code = (inside * np.array([1, 2, 4, 8])).sum(-1)    # [M]

    def interp(a, b):
        # a, b: corner indices; returns [m, 3] edge crossing points
        va, vb = v[sel, a], v[sel, b]
        t = (iso - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
        t = np.clip(t, 0.0, 1.0)[:, None]
        return p[sel, a] * (1 - t) + p[sel, b] * t

    tris = []
    # one-corner-isolated cases -> 1 triangle (code with 1 bit: that corner
    # is inside; 3 bits: the named corner is the only one outside);
    # two-inside -> 2 triangles
    single = {1: (0, (1, 2, 3)), 2: (1, (0, 2, 3)), 4: (2, (0, 1, 3)),
              8: (3, (0, 1, 2)),
              14: (0, (1, 2, 3)), 13: (1, (0, 2, 3)), 11: (2, (0, 1, 3)),
              7: (3, (0, 1, 2))}
    double = {3: ((0, 1), (2, 3)), 5: ((0, 2), (1, 3)), 9: ((0, 3), (1, 2)),
              6: ((1, 2), (0, 3)), 10: ((1, 3), (0, 2)), 12: ((2, 3), (0, 1))}

    for c, (ci, others) in single.items():
        sel = code == c
        if not sel.any():
            continue
        a, b, d = others
        tri = np.stack([interp(ci, a), interp(ci, b), interp(ci, d)], 1)
        centroid = (p[sel, a] + p[sel, b] + p[sel, d]) / 3
        corner_inside = c in (1, 2, 4, 8)
        ref_in = p[sel, ci] if corner_inside else centroid
        ref_out = centroid if corner_inside else p[sel, ci]
        tris.append(_orient_outward(tri, ref_in, ref_out))
    for c, ((i0, i1), (o0, o1)) in double.items():
        sel = code == c
        if not sel.any():
            continue
        # quad with corners on the 4 edges between {i0,i1} and {o0,o1}
        e00 = interp(i0, o0)
        e01 = interp(i0, o1)
        e10 = interp(i1, o0)
        e11 = interp(i1, o1)
        ref_in = (p[sel, i0] + p[sel, i1]) / 2
        ref_out = (p[sel, o0] + p[sel, o1]) / 2
        tris.append(_orient_outward(np.stack([e00, e01, e11], 1),
                                    ref_in, ref_out))
        tris.append(_orient_outward(np.stack([e00, e11, e10], 1),
                                    ref_in, ref_out))
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(tris, 0)


def marching_tetrahedra(volume: np.ndarray, iso: float,
                        origin=(0, 0, 0), spacing=(1, 1, 1)
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """volume: [X, Y, Z] scalar field. Returns (vertices [V,3],
    triangles [T,3] int) of the iso-surface, with duplicate vertices merged."""
    X, Y, Z = volume.shape
    # cell corner values: [X-1, Y-1, Z-1, 8]
    vals = np.stack([
        volume[cx: X - 1 + cx, cy: Y - 1 + cy, cz: Z - 1 + cz]
        for cx, cy, cz in _CORNERS.astype(int)
    ], axis=-1)
    base = np.stack(np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                                np.arange(Z - 1), indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float32)
    vals = vals.reshape(-1, 8)

    # quick cull: only cells crossing the iso level
    crossing = (vals.max(-1) > iso) & (vals.min(-1) <= iso)
    base, vals = base[crossing], vals[crossing]

    all_tris = []
    for tet in _TETS:
        p = base[:, None, :] + _CORNERS[tet][None]     # [M, 4, 3]
        v = vals[:, tet]                               # [M, 4]
        all_tris.append(_tet_triangles(p, v, iso))
    tris = np.concatenate(all_tris, 0)                 # [K, 3, 3]

    if len(tris) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # merge duplicate vertices
    flat = tris.reshape(-1, 3)
    key = np.round(flat / 1e-5).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3), np.float64)
    np.add.at(verts, inv, flat)
    counts = np.bincount(inv, minlength=len(uniq))[:, None]
    verts = (verts / counts).astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]

    verts = verts * np.asarray(spacing, np.float32) + np.asarray(origin,
                                                                 np.float32)
    return verts, faces


def extract_geometry(bound_min, bound_max, resolution: int, threshold: float,
                     query_func: Callable[[np.ndarray], np.ndarray],
                     chunk: int = 65536) -> Tuple[np.ndarray, np.ndarray]:
    """Sample `query_func` (density) on a grid and mesh the iso-surface
    (reference nerf_triplane/utils.py:348-378 API)."""
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    axes = [np.linspace(bound_min[i], bound_max[i], resolution)
            for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    sigmas = np.concatenate([
        np.asarray(query_func(pts[i: i + chunk]))
        for i in range(0, len(pts), chunk)])
    vol = sigmas.reshape(resolution, resolution, resolution)
    spacing = (bound_max - bound_min) / (resolution - 1)
    return marching_tetrahedra(vol, threshold, origin=bound_min,
                               spacing=spacing)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "wb") as f:
        header = (
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
        f.write(header.encode())
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n".encode())
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())
