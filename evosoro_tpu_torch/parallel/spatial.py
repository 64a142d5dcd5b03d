"""Spatially-sharded rollouts: lattice slabs over several devices with a
halo exchange.

The port of `evosoro_tpu.parallel.spatial`. The reference never shards a
single simulation (each fits one process — SURVEY.md §2.4); this runs one
robot's lattice as slabs along X, one slab a mesh entry (and, under a
process group, the ranks' slabs in rank order). The 6-neighbour beam-bond
stencil (reference: VX_Sim.cpp:1763 Integrate) needs one voxel slab of
(pos, quat, scale) and of boundary-bond state from each X-neighbour per step.

Scheme (one-slab halo, recompute-boundary), as in the JAX package:
- each slab owns planes [lo, hi); per step it builds an extended state
  [lo-w, hi+w) from its neighbours' boundary planes, runs the port's
  unmodified eager `core.step.sim_step` on the extended arrays, and keeps
  the interior. The boundary bond is recomputed identically on both owners,
  so its damping-frame memory stays consistent. w is 1, and 2 with volume
  effects (the bond stress reads the neighbour's voxel-pass strains, which
  read its neighbours' bond strains — reference: VXS_Voxel.cpp:543-632).
- volume effects recompute dt from the largest bond frequency: each slab's
  is found first (its step run up to that point), the largest over the
  slabs is the step's `dt_reduce`.
- the divergence latch is a max over the slabs each step, so all slabs
  freeze a diverged rollout together.
- the CoM is the mass-weighted sum of the slabs' partial sums, in slab
  order.

In one process the halo is a copy between the slabs' devices. Across
processes it is a collective: every rank all-gathers the slabs' boundary
planes, moved to the host (`all_gather_object`), which gloo and NCCL both
carry (gloo's point-to-point send/recv takes host tensors only), and the
slabs' frequency and latch maxima and CoM sums the same way.

Global lattice edges keep their False bond masks through the halo, so the
wrap-around planes at the world boundary are always masked out.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from evosoro_tpu_torch.core.rollout import init_state
from evosoro_tpu_torch.core.step import sim_step
from evosoro_tpu_torch.core.types import EnvParams, SimParams, SimState, VoxelBody, _Replace
from evosoro_tpu_torch.parallel.mesh import (
    allgather_objects,
    as_mesh,
    check_mesh,
    process_split,
    tree_map,
)


def supports_spatial(body: VoxelBody, sim: SimParams, env: EnvParams) -> bool:
    """Feature envelope of the spatial sharding scheme (the JAX package's).
    Excluded features couple distant voxels inside one step (self-collision,
    the facet drag, env-source global scans) or reduce global per-step
    state the scheme does not exchange (equilibrium mode's KE history). The
    port also leaves out the limited floor, whose centre the step takes from
    the lattice's X and Y size, which a slab does not have."""
    return (
        body.collision is None
        and body.mesh_drag is None
        and env.sources is None
        and not sim.equilibrium_mode
        and not env.needle_in_haystack
        and not env.falling_prohibited
        and not env.floor_limited
    )


# per-field lattice-X axis of one robot's fields, by dataclass field name:
# (X,Y,Z[,c]) fields -> 0; (3,X,Y,Z[,c]) per-direction fields -> 1;
# (2,3,X,Y,Z) volume-effects carries -> 2; absent -> not sharded
_FIELD_X_AXIS = {
    # SimState
    "pos": 0, "quat": 0, "linmom": 0, "angmom": 0, "scale": 0,
    "last_scale": 0, "small_angle": 1, "last_pos2": 1, "last_angle1": 1,
    "last_angle2": 1, "max_strain": 1, "strain_offset": 1,
    "ts_sum": 2, "cs_area": 2, "devo": 0,
    # VoxelBody
    "occ": 0, "mat": 0, "nom_pos": 0,
    "mass": 0, "mass_inv": 0, "inertia": 0, "inertia_inv": 0,
    "first_moment": 0, "e_mod": 0, "poisson": 0, "cte": 0,
    "u_static": 0, "u_dynamic": 0, "lin_stiffness": 0, "two_sq_mexs": 0,
    "two_sq_iexsss": 0, "phase_offset": 0, "final_phase_offset": 0,
    "temp_amp_damp": 0, "final_temp_amp_damp": 0, "initial_voxel_size": 0,
    "final_voxel_size": 0, "growth_time": 0, "start_growth_time": 0,
    "dof_fixed": 0, "external_force": 0, "external_disp": 0,
    "external_tdisp": 0, "bond_mask": 1, "bond_homogeneous": 1,
    "bond_e": 1, "bond_e1": 1, "bond_e2": 1, "bond_a1": 1, "bond_a2": 1,
    "bond_b1": 1, "bond_b2": 1, "bond_b3": 1,
    "d_a1m1": 1, "d_a1m2": 1, "d_a2i1": 1, "d_a2i2": 1, "d_b1m1": 1,
    "d_b1m2": 1, "d_b2fm1": 1, "d_b2fm2": 1, "d_b3i1": 1, "d_b3i2": 1,
    "plastic_mod": 0, "yield_stress": 0, "mat_temp_phase": 0, "mat_model_vox": 0,
    "ss_strain_vox": 0, "ss_stress_vox": 0, "ss_fail_strain_vox": 0,
    "ss_last_stress_vox": 0, "ss_last_slope_vox": 0,
    "stiffness_plasticity_rate": 0, "kp": 0, "ki": 0, "antiwindup": 0,
    "bond_u": 1, "bond_eh": 1,
}


def _map_fields(fn, obj):
    """`fn(tensor, X axis, name)` over the sharded tensor fields of a
    SimState or VoxelBody, names flattened (DevoState's per-voxel fields as
    "devo.<field>" along axis 0, its window scalars not sharded); other
    fields pass through."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        ax = _FIELD_X_AXIS.get(f.name)
        if ax is None or v is None:
            continue
        if f.name == "devo":
            out[f.name] = v.replace(**{
                g.name: fn(getattr(v, g.name), 0, f"devo.{g.name}")
                for g in dataclasses.fields(v) if not g.name.startswith("win_")})
        elif torch.is_tensor(v):
            out[f.name] = fn(v, ax, f.name)
    return obj.replace(**out)


def _slab(obj, k: int, width: int, device):
    return _map_fields(lambda a, ax, _: a.narrow(ax, k * width, width).to(device), obj)


def _planes(obj, w: int):
    """(first w planes, last w planes) of every sharded field, by name."""
    first, last = {}, {}

    def take(a, ax, name):
        first[name] = a.narrow(ax, 0, w)
        last[name] = a.narrow(ax, a.shape[ax] - w, w)
        return a

    _map_fields(take, obj)
    return first, last


def _extend(obj, left: dict, right: dict):
    """`obj` with the left neighbour's last planes before and the right
    neighbour's first planes after, along each field's X axis."""
    return _map_fields(
        lambda a, ax, name: torch.cat([left[name].to(a.device), a,
                                       right[name].to(a.device)], dim=ax), obj)


def _interior(obj, w: int):
    return _map_fields(lambda a, ax, _: a.narrow(ax, w, a.shape[ax] - 2 * w), obj)


def _halo_extend(slabs: list, w: int, n_slabs: int, first_index: int) -> list:
    """Each local slab extended by its neighbours' `w` boundary planes. The
    boundary planes of every slab come from the ranks' all-gather under a
    process group (held on the host), else from the local slabs."""
    planes = [_planes(s, w) for s in slabs]
    if process_split()[1] > 1:
        planes = [p for rank_planes in allgather_objects(planes) for p in rank_planes]
    return [_extend(s, planes[(first_index + i - 1) % n_slabs][1],
                    planes[(first_index + i + 1) % n_slabs][0])
            for i, s in enumerate(slabs)]


def _gather_values(values: list) -> list:
    """Every slab's value (tensors), in slab order, across the ranks."""
    if process_split()[1] > 1:
        return [v for rank_vals in allgather_objects(values) for v in rank_vals]
    return values


class _Frequency(Exception):
    """Carries a slab's largest bond frequency out of its step (`dt_reduce`
    raises it at the point where the step would reduce it)."""


def _probe_frequency(state, body, sim, env, dt):
    def stop(max_freq):
        raise _Frequency(max_freq)

    try:
        sim_step(state, body, sim, env, dt, dt_reduce=stop)
    except _Frequency as e:
        return e.args[0]
    raise RuntimeError("volume effects are on, but the step reduced no frequency")


@dataclasses.dataclass
class SpatialRolloutResult(_Replace):
    """Reduced outputs of a spatially-sharded rollout (the locomotion subset
    of core.rollout.RolloutResult), on the first mesh entry's device; the
    final state is the slabs gathered into the whole lattice."""

    final_state: SimState
    ini_cm: Any
    final_cm: Any
    final_dist: Any  # |ΔCoM_xy| / lattice_dim (VX_SimGA.cpp:36)
    final_dist_y: Any
    diverged: Any


def spatial_rollout(
    body: VoxelBody,
    sim: SimParams,
    env: EnvParams,
    num_steps: int,
    dt,
    mesh,
    axis: str = "space",
    state: SimState | None = None,
) -> SpatialRolloutResult:
    """Run one rollout with the lattice cut along X into one slab a mesh
    entry (`mesh`: a `parallel.mesh.Mesh` or a list of devices, which may
    repeat). Under a process group every rank gives its own mesh of the same
    size and the slabs are the ranks' in rank order. The body's X size must
    divide by the number of slabs, each slab at least as thick as the halo.
    The entries must be devices of the body's type. Returns reduced fitness
    plus the final state gathered on the first entry's device. `axis` is
    kept for the JAX package's signature."""
    mesh = check_mesh(as_mesh(mesh), body.occ.device)
    if not supports_spatial(body, sim, env):
        raise ValueError("configuration outside the spatial-sharding envelope")
    if body.occ.dim() != 3:
        raise ValueError("spatial_rollout takes one robot: a batched body is refused")
    rank, world = process_split()
    n_slabs = world * len(mesh)
    X = body.occ.shape[0]
    if X % n_slabs:
        raise ValueError(f"lattice X={X} not divisible by mesh axis {n_slabs}")
    if state is None:
        state = init_state(body, volume_effects=sim.volume_effects_enabled,
                           ballistic_devo=False)
    vol = sim.volume_effects_enabled
    w = 2 if vol else 1
    width = X // n_slabs
    if width < w:
        raise ValueError(f"local slab {width} thinner than halo width {w}")

    dev0 = mesh[0]
    first = rank * len(mesh)
    bodies = [_slab(body, first + i, width, d) for i, d in enumerate(mesh)]
    slabs = [_slab(state, first + i, width, d) for i, d in enumerate(mesh)]
    ext_bodies = _halo_extend(bodies, w, n_slabs, first)
    total_mass = body.mass.to(dev0).sum()
    L = body.nominal_size

    def cm(states):
        parts = _gather_values([(s.pos * b.mass[..., None]).sum(dim=(0, 1, 2))
                                for s, b in zip(states, bodies)])
        return torch.stack([p.to(dev0) for p in parts]).sum(0) / total_mass

    def agree(values, reduce):
        return reduce(torch.stack([v.to(dev0) for v in _gather_values(values)]))

    ini_cm = cm(slabs)
    captured = torch.zeros((), dtype=torch.bool, device=dev0)
    for _ in range(num_steps):
        time_now = slabs[0].time.to(dev0)
        capture = (~captured) & (time_now > sim.init_cm_time)
        ini_cm = torch.where(capture, cm(slabs), ini_cm)
        captured = captured | capture

        ext = _halo_extend(slabs, w, n_slabs, first)
        reduce_dt = None
        if vol:
            # every slab's step must take the largest frequency of them all
            top = agree([_probe_frequency(e, b, sim, env, dt)
                         for e, b in zip(ext, ext_bodies)], lambda t: t.max(0).values)
            reduce_dt = lambda f, top=top: top.to(f.device)  # noqa: E731
        slabs = [_interior(sim_step(e, b, sim, env, dt, dt_reduce=reduce_dt), w)
                 for e, b in zip(ext, ext_bodies)]
        latch = agree([s.diverged for s in slabs], lambda t: t.any(0))
        slabs = [s.replace(diverged=latch.to(s.diverged.device)) for s in slabs]

    # per-slab energy and velocity summaries -> one value (boundary bonds
    # count in two slabs' sums: a summary, as in the JAX package)
    final = _gather_state(slabs, dev0).replace(
        ke_history=agree([s.ke_history for s in slabs], lambda t: t.mean(0)),
        total_strain_e=agree([s.total_strain_e for s in slabs], lambda t: t.mean(0)),
        max_vox_vel=agree([s.max_vox_vel for s in slabs], lambda t: t.max(0).values))
    if final.cur_dt is not None:
        final = final.replace(cur_dt=agree([s.cur_dt for s in slabs], lambda t: t.max(0).values),
                              time=agree([s.time for s in slabs], lambda t: t.max(0).values))
    final_cm = cm(slabs)
    delta = final_cm - ini_cm
    dsq = delta[0] ** 2 + delta[1] ** 2
    dist = torch.where(dsq > 0, torch.sqrt(torch.where(dsq > 0, dsq, 1.0)), 0.0) / L
    return SpatialRolloutResult(final_state=final, ini_cm=ini_cm, final_cm=final_cm,
                                final_dist=dist, final_dist_y=delta[1] / L,
                                diverged=final.diverged)


def _gather_state(slabs: list, device) -> SimState:
    """The slabs' states joined along X on `device` (across the ranks under a
    process group); unsharded fields from the first slab."""
    every = _gather_values(slabs)
    whole = _map_fields(lambda a, ax, name: torch.cat(
        [_field(s, name).to(device) for s in every], dim=ax), every[0])
    return tree_map(lambda t: t.to(device), whole)


def _field(state, name):
    head, _, tail = name.partition(".")
    v = getattr(state, head)
    return getattr(v, tail) if tail else v
