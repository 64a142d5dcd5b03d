"""Mesh-accurate fluid drag: per-facet quadratic drag on the deformed
surface mesh (the land_water fork's aquatic model).

The port of `evosoro_tpu.envs.drag`. Reference:
`_voxcad_land_water/Voxelyze/VX_Sim.cpp:1516-1600`: each step the deformable
surface mesh is updated from voxel poses (`UpdateMeshPhysicsOnlyNoColors`,
VX_MeshUtil.cpp:368-421: vertex = average over its adjacent voxels of
pos + R·(corner offset scaled), weight 1.0), then for every triangular
facet: area from the edge cross product, facet normal, the *owner voxel's*
velocity projected on the normal (only when v·n > 0), and

    drag = − C_agg · Area · |v_n|² · n̂,  accumulated onto the owner voxel
    (FacetToSIndex linkage, VX_MeshUtil.cpp:192-193).

Mesh topology is static per design, so it precomputes to gather tables
(triangle → 3 vertex ids → ≤ 8 adjacent voxels each, triangle → owner
voxel); the per-step update is gather → elementwise → scatter-add. This
formulation is the plain version of the fused rollout kernel's corner-
lattice stencil (`ops/csrc/fused_rollout_common.cuh`), and what the eager
step uses when the body carries a `MeshDragSystem`; without one it takes
the voxel-face approximation (`core.step._fluid_drag`). Where the JAX
package `vmap`s, the tables and the fields take a leading batch shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from evosoro_tpu_torch.core import quaternion as q
from evosoro_tpu_torch.core.types import _Replace

# face normal direction, corner-quad (in corner-lattice coords relative to
# the voxel's min corner): same winding as the reference's marched surface
_FACES = [
    ((+1, 0, 0), [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)]),
    ((-1, 0, 0), [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)]),
    ((0, +1, 0), [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)]),
    ((0, -1, 0), [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)]),
    ((0, 0, +1), [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]),
    ((0, 0, -1), [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)]),
]


@dataclasses.dataclass
class MeshDragSystem(_Replace):
    """Static surface-mesh drag tables for one design, or for a batch of
    designs padded to common sizes (a leading batch shape on every field)."""

    # vertices: V surface corners, each averaging <= 8 adjacent voxels
    vert_vox: Any  # (..., V, 8) int64 flat voxel index (padded with 0)
    vert_sign: Any  # (..., V, 8, 3) corner sign (+-1) per adjacent voxel
    vert_w: Any  # (..., V, 8) 1.0 for live slots, 0.0 padding
    # triangles
    tri_verts: Any  # (..., T, 3) int64 indices into the vertex arrays
    tri_owner: Any  # (..., T) int64 flat voxel index owning the facet
    tri_mask: Any  # (..., T) bool (False = padding row)

    @property
    def num_tris(self):
        return self.tri_verts.shape[-2]


def mesh_tables(structure, pad_tris: int | None = None,
                pad_verts: int | None = None) -> dict:
    """The numpy tables of `build_mesh_drag` (same keys as the fields)."""
    structure = np.asarray(structure)
    occ = structure > 0
    X, Y, Z = occ.shape
    occp = np.pad(occ, 1)

    # exposed faces -> triangles (two per quad, owner = the voxel)
    corner_of = {}
    corners = []

    def corner_id(cx, cy, cz):
        key = (cx, cy, cz)
        if key not in corner_of:
            corner_of[key] = len(corners)
            corners.append(key)
        return corner_of[key]

    tri_verts, tri_owner = [], []
    for (dx, dy, dz), quad in _FACES:
        exposed = occ & (
            occp[1 + dx:X + 1 + dx, 1 + dy:Y + 1 + dy, 1 + dz:Z + 1 + dz] == 0
        )
        for vx, vy, vz in np.argwhere(exposed):
            vids = [corner_id(vx + cx, vy + cy, vz + cz) for cx, cy, cz in quad]
            flat = (vx * Y + vy) * Z + vz
            tri_verts.append([vids[0], vids[1], vids[2]])
            tri_verts.append([vids[0], vids[2], vids[3]])
            tri_owner += [flat, flat]

    T0 = len(tri_verts)
    T = int(pad_tris) if pad_tris is not None else T0
    if T < T0:
        raise ValueError(f"pad_tris={T} < triangle count {T0}")
    V0 = len(corners)
    V = int(pad_verts) if pad_verts is not None else V0
    if V < V0:
        raise ValueError(f"pad_verts={V} < vertex count {V0}")

    # vertex -> adjacent occupied voxels (weight 1 each)
    vert_vox = np.zeros((V, 8), dtype=np.int32)
    vert_sign = np.zeros((V, 8, 3), dtype=np.int8)
    vert_w = np.zeros((V, 8), dtype=np.float32)
    for vi, (cx, cy, cz) in enumerate(corners):
        k = 0
        for vx in (cx - 1, cx):
            for vy in (cy - 1, cy):
                for vz in (cz - 1, cz):
                    if 0 <= vx < X and 0 <= vy < Y and 0 <= vz < Z and occ[vx, vy, vz]:
                        vert_vox[vi, k] = (vx * Y + vy) * Z + vz
                        vert_sign[vi, k] = (
                            1 if cx == vx + 1 else -1,
                            1 if cy == vy + 1 else -1,
                            1 if cz == vz + 1 else -1,
                        )
                        vert_w[vi, k] = 1.0
                        k += 1

    tv = np.zeros((T, 3), dtype=np.int32)
    to = np.zeros((T,), dtype=np.int32)
    tm = np.zeros((T,), dtype=bool)
    if T0:
        tv[:T0] = np.asarray(tri_verts, dtype=np.int32)
        to[:T0] = np.asarray(tri_owner, dtype=np.int32)
        tm[:T0] = True
    return dict(vert_vox=vert_vox, vert_sign=vert_sign.astype(np.float32),
                vert_w=vert_w, tri_verts=tv, tri_owner=to, tri_mask=tm)


def mesh_from_tables(tables: dict, device=None, dtype=torch.float32) -> MeshDragSystem:
    """Numpy tables (one design's, or stacked along a leading axis) as a
    MeshDragSystem on `device`; index tables become int64."""
    out = {}
    for k, v in tables.items():
        v = np.array(v)  # a copy: the source may be read-only
        if v.dtype == np.bool_:
            out[k] = torch.as_tensor(v, device=device)
        elif np.issubdtype(v.dtype, np.integer):
            out[k] = torch.as_tensor(v.astype(np.int64), device=device)
        else:
            out[k] = torch.as_tensor(v, device=device).to(dtype)
    return MeshDragSystem(**out)


def build_mesh_drag(structure, pad_tris: int | None = None,
                    pad_verts: int | None = None, device=None,
                    dtype=torch.float32) -> MeshDragSystem:
    """Host-side precompute of the surface mesh linkage for one design.
    `pad_tris` / `pad_verts` fix T and V so heterogeneous designs stack
    (padding rows have tri_mask False / vert_w 0)."""
    return mesh_from_tables(mesh_tables(structure, pad_tris, pad_verts),
                            device=device, dtype=dtype)


def build_mesh_drag_batch(structures, device=None, dtype=torch.float32) -> MeshDragSystem:
    """One MeshDragSystem for a batch of designs (B, X, Y, Z), every table
    padded to the batch's largest triangle and vertex counts."""
    raw = [mesh_tables(s) for s in structures]
    t_max = max(r["tri_verts"].shape[0] for r in raw)
    v_max = max(r["vert_vox"].shape[0] for r in raw)
    padded = [mesh_tables(s, pad_tris=t_max, pad_verts=v_max) for s in structures]
    return mesh_from_tables({k: np.stack([p[k] for p in padded]) for k in padded[0]},
                            device=device, dtype=dtype)


def attach_mesh_drag(body, pad_tris: int | None = None):
    """Return `body` with its MeshDragSystem built and attached."""
    return body.replace(mesh_drag=build_mesh_drag(
        body.mat.cpu().numpy(), pad_tris=pad_tris, device=body.mass.device,
        dtype=body.mass.dtype))


def _take(a, idx, nb, per_robot):
    """Rows `idx` of `a` (*batch, N, ...) along axis `nb` (the voxel or
    vertex axis). `idx` has no batch shape (one design for the whole batch)
    or, with `per_robot`, starts with the batch shape (a table per robot)."""
    batch = a.shape[:nb]
    if per_robot:
        n = a.shape[nb]
        flat = a.reshape((-1,) + tuple(a.shape[nb + 1:]))
        base = torch.arange(flat.shape[0] // n, device=a.device) * n
        base = base.reshape(tuple(batch) + (1,) * (idx.dim() - nb))
        return flat[idx + base]
    return a[(slice(None),) * nb + (idx,)]


def mesh_drag_forces(pos, quat, scale, linmom, mass_inv, sys: MeshDragSystem,
                     drag_coefficient, strain_pos=None, strain_neg=None,
                     nominal_size=None):
    """(..., X, Y, Z, 3) drag force field from the deformed surface mesh.

    Replicates the reference per-facet model (land_water VX_Sim.cpp:1524-1581)
    with vertex positions per UpdateMeshPhysicsOnlyNoColors / GetCurVLoc
    (VX_MeshUtil.cpp:368-421): vertex = mean over its adjacent voxels of
    pos + R_vox·corner_offset. The reference's corner offsets are per-axis
    strain-based: CornerPosCur = (1+StrainPosDirsCur)·NominalSize/2, from
    the bond strains written each step (land_water VXS_Voxel.cpp:474-475,
    VXS_BondInternal.cpp:301-303). Pass `strain_pos`/`strain_neg`
    ((..., 3, X, Y, Z), bond-masked) and `nominal_size` for that path;
    without them a scale-based approximation (0.5·scale·sign) is used
    (identical at rest). `drag_coefficient` is a float or a tensor of the
    batch shape."""
    shape3 = tuple(pos.shape[:-1])
    nb = len(shape3) - 3
    batch = shape3[:nb]
    posf = pos.reshape(batch + (-1, 3))
    quatf = quat.reshape(batch + (-1, 4))
    scalef = scale.reshape(batch + (-1,))
    velf = (linmom * mass_inv[..., None]).reshape(batch + (-1, 3))

    # vertex positions
    per = sys.vert_vox.dim() > 2  # a table per robot
    if per and tuple(sys.vert_vox.shape[:-2]) != tuple(batch):
        raise ValueError("a batched MeshDragSystem must carry the fields' "
                         f"batch shape {tuple(batch)}")
    vvox = sys.vert_vox  # (..., V, 8)
    p = _take(posf, vvox, nb, per)  # (..., V, 8, 3)
    qv = _take(quatf, vvox, nb, per)  # (..., V, 8, 4)
    if strain_pos is not None:
        spf = strain_pos.reshape(batch + (3, -1)).transpose(-1, -2)  # (..., N, 3)
        snf = strain_neg.reshape(batch + (3, -1)).transpose(-1, -2)
        sel = torch.where(sys.vert_sign > 0, _take(spf, vvox, nb, per),
                          _take(snf, vvox, nb, per))
        off = sys.vert_sign * (0.5 * nominal_size) * (1.0 + sel)
    else:
        s = _take(scalef, vvox, nb, per)  # (..., V, 8)
        off = 0.5 * s[..., None] * sys.vert_sign
    world = p + q.quat_rotate(qv, off)
    wsum = sys.vert_w.sum(-1)
    vpos = (world * sys.vert_w[..., None]).sum(-2) / torch.clamp(
        wsum, min=1.0)[..., None]

    # facet area / normal / projected owner velocity
    a = _take(vpos, sys.tri_verts[..., 0], nb, per)
    b = _take(vpos, sys.tri_verts[..., 1], nb, per)
    c = _take(vpos, sys.tri_verts[..., 2], nb, per)
    n = torch.linalg.cross(b - a, c - a)  # |n| = 2*Area
    n_len = torch.sqrt(torch.clamp((n * n).sum(-1), min=1e-30))
    area = 0.5 * n_len
    n_hat = n / n_len[..., None]

    vel = _take(velf, sys.tri_owner, nb, per)  # (..., T, 3)
    vn = (vel * n_hat).sum(-1)
    # forward-facing only: angle(v, n) < π/2 ⇔ v·n > 0 (reference: :1560)
    fwd = sys.tri_mask & (vn > 0)
    c_drag = drag_coefficient
    if torch.is_tensor(c_drag) and c_drag.dim() > 0:
        c_drag = c_drag[..., None]
    mag = torch.where(fwd, c_drag * area * vn * vn, 0.0)
    drag = -mag[..., None] * n_hat  # (..., T, 3)

    # scatter-add onto the owners (a table per robot: offset by the robot)
    N = posf.shape[-2]
    dense = torch.zeros((int(np.prod(batch)) * N, 3), dtype=pos.dtype,
                        device=pos.device)
    owner = sys.tri_owner.expand(batch + (sys.tri_owner.shape[-1],))
    base = (torch.arange(int(np.prod(batch)), device=pos.device) * N).reshape(
        batch + (1,))
    dense.index_add_(0, (owner + base).reshape(-1),
                     drag.expand(batch + tuple(drag.shape[-2:])).reshape(-1, 3))
    return dense.reshape(shape3 + (3,))
