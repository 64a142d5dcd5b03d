"""Smoothed isosurface extraction from voxel occupancy.

The reference's GUI meshes robots with marching cubes
(reference: evosoro/_voxcad/Voxelyze/Utils/MarchCube.cpp
CMarchCube::SingleMaterialMultiColor — density field sampled at voxel
centers, isolevel surfacing, vertex interpolation along cell edges). This
module provides the same capability — a watertight smoothed surface whose
volume converges to the voxel volume — via **marching tetrahedra**: each
lattice cell splits into 6 tetrahedra, and each tet contributes 0/1/2
triangles with vertices linearly interpolated along crossing edges. The
tetra variant needs no 256-case tables, has no ambiguous (hole-producing)
cases, and vectorizes over every tet at once, which suits this codebase's
dense-array style. Output feeds io/mesh_io.write_stl / write_obj and the
viz renderer.

All host-side numpy (viz/export path, not the rollout's hot loop): the
port's copy of `evosoro_tpu.viz.marching`.
"""

from __future__ import annotations

import numpy as np

# Kuhn 6-tetrahedra decomposition of the unit cube (paths 0→7 adding one
# axis at a time); corners are xyz bit-coded: corner k = (k&1,(k>>1)&1,
# (k>>2)&1). Kuhn is FACE-CONSISTENT under translation — adjacent cubes
# agree on every shared-face diagonal, so the welded surface is crack-free.
_CUBE_TETS = np.array([
    [0, 1, 3, 7],
    [0, 1, 5, 7],
    [0, 2, 3, 7],
    [0, 2, 6, 7],
    [0, 4, 5, 7],
    [0, 4, 6, 7],
], dtype=np.int32)

_CORNERS = np.array(
    [[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)],
    dtype=np.float64,
)

# tet edges as (corner a, corner b) local ids 0..3
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32)

# case table over the 16 inside-masks of a tet's 4 corners: each entry is a
# list of triangles, each triangle a triple of tet-edge ids (connectivity
# only — winding is fixed afterwards by the inside-corner orientation test)
_TET_TRIS = {
    0b0001: [(0, 1, 2)],
    0b1110: [(0, 1, 2)],
    0b0010: [(0, 4, 3)],
    0b1101: [(0, 4, 3)],
    0b0100: [(1, 3, 5)],
    0b1011: [(1, 3, 5)],
    0b1000: [(2, 5, 4)],
    0b0111: [(2, 5, 4)],
    0b0011: [(1, 2, 4), (1, 4, 3)],
    0b1100: [(1, 2, 4), (1, 4, 3)],
    0b0101: [(0, 3, 5), (0, 5, 2)],
    0b1010: [(0, 3, 5), (0, 5, 2)],
    0b0110: [(0, 4, 5), (0, 5, 1)],
    0b1001: [(0, 4, 5), (0, 5, 1)],
}


def occupancy_field(structure: np.ndarray) -> np.ndarray:
    """Zero-padded density field sampled at voxel centers (the reference
    pads with empty space so closed surfaces form at the boundary,
    MarchCube.cpp:118-133)."""
    occ = (np.asarray(structure) > 0).astype(np.float64)
    return np.pad(occ, 1)


def marching_tetrahedra(
    field: np.ndarray,
    iso: float = 0.5,
    spacing: float = 1.0,
    origin=(0.0, 0.0, 0.0),
):
    """Extract the iso-surface of a 3D scalar field.

    Grid points are field samples; cells between 8 neighboring samples are
    surfaced. Returns (verts (V,3) float64, faces (F,3) int32) with shared
    (deduplicated) vertices — every surface edge borders exactly 2 faces.
    """
    f = np.asarray(field, dtype=np.float64)
    nx, ny, nz = f.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int32)

    # cell corner values: (cx, cy, cz, 8)
    base = np.stack(np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
        indexing="ij"), axis=-1)  # (cx,cy,cz,3)
    corner_off = _CORNERS.astype(np.int64)  # (8,3)
    idx = base[..., None, :] + corner_off  # (cx,cy,cz,8,3)
    vals = f[idx[..., 0], idx[..., 1], idx[..., 2]]  # (cx,cy,cz,8)

    cells = base.reshape(-1, 3)
    vals = vals.reshape(-1, 8)
    # drop cells the surface cannot cross
    crossing = (vals.min(axis=1) < iso) & (vals.max(axis=1) >= iso)
    cells, vals = cells[crossing], vals[crossing]
    if cells.shape[0] == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int32)

    # expand to tets: (n_cells, 6, 4) values and corner positions
    tet_vals = vals[:, _CUBE_TETS]  # (n,6,4)
    tet_pos = (cells[:, None, None, :] + _CORNERS[_CUBE_TETS])  # (n,6,4,3)
    tet_vals = tet_vals.reshape(-1, 4)
    tet_pos = tet_pos.reshape(-1, 4, 3)

    inside = tet_vals >= iso  # (m,4)
    mask = (inside * np.array([1, 2, 4, 8])).sum(axis=1)

    tri_pts = []
    for case, tris in _TET_TRIS.items():
        sel = mask == case
        if not sel.any():
            continue
        v = tet_vals[sel]  # (s,4)
        p = tet_pos[sel]  # (s,4,3)
        # interpolated point on each of the 6 tet edges
        a, b = _TET_EDGES[:, 0], _TET_EDGES[:, 1]
        va, vb = v[:, a], v[:, b]  # (s,6)
        denom = vb - va
        t = np.where(np.abs(denom) > 1e-12, (iso - va) / np.where(
            np.abs(denom) > 1e-12, denom, 1.0), 0.5)
        t = np.clip(t, 0.0, 1.0)
        pts = p[:, a] + t[..., None] * (p[:, b] - p[:, a])  # (s,6,3)
        # orient each triangle so its normal points away from the inside
        # region (the iso-plane separates the inside corner from outside,
        # so the sign test is never degenerate)
        ic = next(k for k in range(4) if (case >> k) & 1)
        ic_pos = p[:, ic]  # (s,3)
        for tri in tris:
            tp = pts[:, list(tri)]  # (s,3,3)
            n = np.cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0])
            outward = np.einsum(
                "ij,ij->i", n, tp.mean(axis=1) - ic_pos)
            tp = np.where((outward < 0)[:, None, None], tp[:, ::-1], tp)
            tri_pts.append(tp)
    tri_pts = np.concatenate(tri_pts, axis=0)  # (F,3,3)

    # weld shared vertices: edge-interpolated points from adjacent tets are
    # bit-identical (same endpoints, same t), so exact dedup is safe
    flat = tri_pts.reshape(-1, 3)
    uniq, inv = np.unique(flat.round(decimals=9), axis=0,
                          return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate triangles (two welded corners)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]
    verts = uniq * float(spacing) + np.asarray(origin, dtype=np.float64)
    return verts, faces


def smooth_structure_mesh(structure: np.ndarray, lattice_dim: float = 1.0,
                          iso: float = 0.5):
    """Watertight smoothed surface of a voxel design, registered to the
    engine's frame: voxel (i,j,k)'s center sits at (i+0.5)·lattice_dim —
    the same nominal positions build_body uses (core/materials.py nom_pos),
    so the surface overlays deformed-mesh/viz output without offset."""
    field = occupancy_field(structure)
    # field sample (1,1,1) is voxel (0,0,0)'s center at 0.5·lattice_dim
    half = -0.5 * lattice_dim
    return marching_tetrahedra(
        field, iso=iso, spacing=lattice_dim, origin=(half, half, half),
    )


def mesh_volume(verts: np.ndarray, faces: np.ndarray) -> float:
    """Signed volume by the divergence theorem (tetrahedra to the origin);
    positive for outward-oriented watertight surfaces."""
    p0 = verts[faces[:, 0]]
    p1 = verts[faces[:, 1]]
    p2 = verts[faces[:, 2]]
    return float(np.einsum("ij,ij->i", p0, np.cross(p1, p2)).sum() / 6.0)
