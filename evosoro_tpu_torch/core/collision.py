"""Self-collision: sphere-envelope contact between surface voxels.

The reference lazily rebuilds an O(surface²) candidate bond list whenever
accumulated motion exceeds the collision horizon (reference: VX_Sim.cpp:
2357-2414 CalcL1Bonds + VXS_BondCollision.cpp:41-59 CalcContactForce +
VX_Voxel.cpp:171 CalcNearby). As in `evosoro_tpu.core.collision`, the static
part is precomputed on the host once per design (numpy, copied from the JAX
package): the surface voxel list and the "nearby in the lattice" pair
exclusion. `collision_forces` then evaluates the full masked S×S pair field
every step, a superset of the reference's candidate list with identical
physics, for one design or for a batch of different designs whose tables
are padded to one S and stacked (`pad_collision_system`,
`stack_collision_systems`).

Contact model (VXS_BondCollision.cpp:41-59): overlap when
dist < 0.75·(s1+s2); repulsion F = a1·overlap along the centre line, no
moments; a1 = E_comp·L with composite E = 2·E1E2/(E1+E2).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class CollisionSystem:
    """Static per-design collision tables (numpy arrays or tensors)."""

    surf_idx: Any  # (S, 3) int32 lattice coords of surface voxels (padded)
    surf_mask: Any  # (S,) bool — False for pad entries
    pair_a1: Any  # (S, S) contact stiffness E_comp·A/L per pair
    allowed: Any  # (S, S) bool — both real, i≠j, not lattice-nearby

    @property
    def num_surface(self):
        return self.surf_idx.shape[0]


def _lattice_hops(occ: np.ndarray) -> "list[np.ndarray]":
    """BFS frontier expansion helper: 6-neighbor shifts of a bool grid."""
    out = []
    for d in range(3):
        for s in (1, -1):
            out.append(np.roll(occ, s, axis=d))
    return out


def build_collision_system(
    structure: np.ndarray,
    e_mod: np.ndarray,
    lattice_dim: float,
    collision_horizon: float = 2.0,
    pad_to: int | None = None,
    dtype=np.float32,
) -> CollisionSystem:
    """Host-side precompute of the collision tables for one design.

    `collision_horizon` matches the reference SimParams value; exclusion uses
    NumHops = int(horizon·1.5) lattice hops through the *bond graph*
    (reference: VX_Sim.cpp:658; VX_Voxel.cpp:171 "does not jump gaps").
    `pad_to` fixes S so heterogeneous designs batch under vmap.
    """
    structure = np.asarray(structure)
    e_mod = np.asarray(e_mod, dtype=np.float64)
    occ = structure > 0
    X, Y, Z = occ.shape

    # surface voxels: any of the 6 internal bonds missing (VX_Voxel.h:80)
    full_nbrs = np.zeros_like(occ, dtype=np.int32)
    for d in range(3):
        for s in (1, -1):
            shifted = np.zeros_like(occ)
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            if s == 1:
                src[d], dst[d] = slice(0, -1), slice(1, None)
            else:
                src[d], dst[d] = slice(1, None), slice(0, -1)
            shifted[tuple(dst)] = occ[tuple(src)]
            full_nbrs += shifted.astype(np.int32)
    surface = occ & (full_nbrs < 6)
    idx = np.argwhere(surface).astype(np.int32)  # (S0, 3)
    S0 = idx.shape[0]
    S = int(pad_to) if pad_to is not None else S0
    if S < S0:
        raise ValueError(f"pad_to={S} < number of surface voxels {S0}")

    surf_idx = np.zeros((S, 3), dtype=np.int32)
    surf_idx[:S0] = idx
    surf_mask = np.zeros((S,), dtype=bool)
    surf_mask[:S0] = True

    # lattice-nearby exclusion: BFS through occupied 6-neighbor bonds.
    num_hops = int(collision_horizon * 1.5)
    flat_id = np.full(occ.shape, -1, dtype=np.int64)
    occ_idx = np.argwhere(occ)
    flat_id[tuple(occ_idx.T)] = np.arange(len(occ_idx))
    n_occ = len(occ_idx)
    # reach[v] = set of occupied voxels within num_hops bond hops of v.
    # Sparse boolean powers of the lattice adjacency: the bond graph has
    # ≤3·n edges, so csr products are ~O(n·deg^hops) — this runs per
    # individual per generation in the evaluator, dense n² powers don't.
    rows_a, cols_a = [], []
    for d in range(3):
        here = occ_idx[:, d] < occ.shape[d] - 1
        nbr = occ_idx.copy()
        nbr[:, d] += 1
        ok = here & (flat_id[tuple(np.clip(nbr, 0, np.array(occ.shape) - 1).T)] >= 0)
        a = flat_id[tuple(occ_idx[ok].T)]
        b = flat_id[tuple(nbr[ok].T)]
        rows_a += [a, b]
        cols_a += [b, a]
    try:
        import scipy.sparse as sp

        rows_cat = np.concatenate(rows_a) if rows_a else np.zeros(0, np.int64)
        cols_cat = np.concatenate(cols_a) if cols_a else np.zeros(0, np.int64)
        adj = sp.csr_matrix(
            (np.ones(len(rows_cat), dtype=bool), (rows_cat, cols_cat)),
            shape=(n_occ, n_occ),
        )
        reach = sp.identity(n_occ, dtype=bool, format="csr")
        for _ in range(num_hops):
            reach = (reach + reach @ adj).astype(bool)
        reach = reach.toarray()
    except ImportError:  # dense fallback
        adj = np.zeros((n_occ, n_occ), dtype=bool)
        for a, b in zip(rows_a, cols_a):
            adj[a, b] = True
        reach = np.eye(n_occ, dtype=bool)
        for _ in range(num_hops):
            reach = reach | (reach @ adj)

    surf_flat = flat_id[tuple(idx.T)]  # (S0,) indices into occ arrays
    nearby = reach[np.ix_(surf_flat, surf_flat)]  # (S0, S0)

    allowed = np.zeros((S, S), dtype=bool)
    real = np.outer(surf_mask[:S0], surf_mask[:S0])
    allowed[:S0, :S0] = real & ~nearby
    np.fill_diagonal(allowed, False)

    # pair contact stiffness a1 = E_comp·A/L = E_comp·L (A=L², L_bond=L)
    e_surf = np.zeros((S,), dtype=np.float64)
    e_surf[:S0] = e_mod[tuple(idx.T)]
    e1 = e_surf[:, None]
    e2 = e_surf[None, :]
    denom = e1 + e2
    e_comp = np.where(denom > 0, 2.0 * e1 * e2 / np.where(denom > 0, denom, 1.0), 0.0)
    pair_a1 = (e_comp * float(lattice_dim)).astype(dtype)
    pair_a1 = np.where(allowed, pair_a1, 0.0).astype(dtype)

    # numpy arrays out: the tables are built per individual per generation
    # on the host; batch callers stack them and copy to the device once
    return CollisionSystem(
        surf_idx=surf_idx,
        surf_mask=surf_mask,
        pair_a1=pair_a1,
        allowed=allowed,
    )


def pad_collision_system(cs: CollisionSystem, S: int) -> CollisionSystem:
    """Zero-pad a CollisionSystem's surface dimension to S so that
    different designs stack into one batch (pad entries are fully masked;
    numpy, on the host)."""
    S0 = cs.surf_idx.shape[0]
    if S0 == S:
        return cs
    if S0 > S:
        raise ValueError(f"cannot shrink collision system {S0} -> {S}")
    pad = S - S0
    return CollisionSystem(
        surf_idx=np.pad(np.asarray(cs.surf_idx), ((0, pad), (0, 0))),
        surf_mask=np.pad(np.asarray(cs.surf_mask), (0, pad)),
        pair_a1=np.pad(np.asarray(cs.pair_a1), ((0, pad), (0, pad))),
        allowed=np.pad(np.asarray(cs.allowed), ((0, pad), (0, pad))),
    )


def stack_collision_systems(systems, device=None, dtype=torch.float32) -> CollisionSystem:
    """One CollisionSystem for a batch of designs: each padded to the
    batch's largest surface count and stacked along a leading batch axis,
    as tensors on `device` (copied once, not every step)."""
    S = max(cs.surf_idx.shape[0] for cs in systems)
    padded = [pad_collision_system(cs, S) for cs in systems]

    def stack(name, **kw):
        return torch.as_tensor(np.stack([np.asarray(getattr(cs, name)) for cs in padded]),
                               device=device, **kw)

    return CollisionSystem(surf_idx=stack("surf_idx", dtype=torch.int64),
                           surf_mask=stack("surf_mask"),
                           pair_a1=stack("pair_a1", dtype=dtype),
                           allowed=stack("allowed"))


def attach_collision_system(body, collision_horizon: float = 2.0,
                            pad_to: int | None = None):
    """Return `body` (one design) with its CollisionSystem built and
    attached."""
    cs = build_collision_system(
        body.mat.cpu().numpy(),
        body.e_mod.cpu().numpy(),
        float(body.nominal_size),
        collision_horizon=collision_horizon,
        pad_to=pad_to,
        dtype=body.nom_pos.cpu().numpy().dtype,
    )
    return body.replace(collision=cs)


def collision_forces(pos, scale, colsys: CollisionSystem):
    """Dense (..., X, Y, Z, 3) contact force field for the current voxel
    poses. `colsys` holds one design's tables (S, ...) or a stack of them
    with leading batch dimensions (..., S, ...), which the leading
    dimensions of `pos` end with (`stack_collision_systems`).

    For each ordered surface pair (i, j): overlap = 0.75·(sᵢ+sⱼ) − |pⱼ−pᵢ|;
    force on i = −a1·overlap·(pⱼ−pᵢ)/|pⱼ−pᵢ| when overlap > 0
    (reference: VXS_BondCollision.cpp:41-59)."""
    dev = pos.device
    idx = torch.as_tensor(colsys.surf_idx, device=dev).to(torch.int64)
    allowed = torch.as_tensor(colsys.allowed, device=dev)
    pair_a1 = torch.as_tensor(colsys.pair_a1, device=dev).to(pos.dtype)
    surf_mask = torch.as_tensor(colsys.surf_mask, device=dev)
    X, Y, Z = pos.shape[-4:-1]
    V, S = X * Y * Z, idx.shape[-2]
    lead = tuple(pos.shape[:-4])
    # each surface entry's flat voxel index, over the state's leading shape
    flat = ((idx[..., 0] * Y + idx[..., 1]) * Z + idx[..., 2]).expand(lead + (S,))
    ps = torch.gather(pos.reshape(lead + (V, 3)), -2,
                      flat[..., None].expand(lead + (S, 3)))  # (..., S, 3)
    sc = torch.gather(scale.reshape(lead + (V,)), -1, flat)  # (..., S)

    diff = ps[..., None, :, :] - ps[..., :, None, :]  # pⱼ − pᵢ at [i, j]
    dist2 = (diff * diff).sum(-1)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-30))
    nom = 0.75 * (sc[..., :, None] + sc[..., None, :])
    overlap = nom - dist
    active = allowed & (overlap > 0.0)
    mag = torch.where(active, pair_a1 * overlap / dist, 0.0)
    f = -(mag[..., None] * diff).sum(-2)  # (..., S, 3), force on i
    f = torch.where(surf_mask[..., None], f, 0.0)

    # surface lattice coordinates are unique within a design, so assignment
    # is the scatter; pad entries (index 0 repeated, zero force) go to a
    # slot past the grid that is dropped
    dst = torch.where(surf_mask.expand(lead + (S,)), flat, V)
    dense = pos.new_zeros(lead + (V + 1, 3)).scatter(
        -2, dst[..., None].expand(lead + (S, 3)), f)
    return dense[..., :V, :].reshape(pos.shape)
