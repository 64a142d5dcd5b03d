"""Carry the JAX package's containers across into this port's dataclasses.

The inputs are `evosoro_tpu` structs whose array leaves are numpy arrays
(for example `jax.tree_util.tree_map(np.asarray, body)`); this module never
imports JAX. Stacked environment params (one value a robot, as a vmapped
evaluator holds them) come across as tensors of the batch shape. Floating
arrays become `dtype` tensors on `device`, boolean and integer arrays keep
their kind, Python scalars and static flags stay as they
are; a body's collision and mesh-drag tables, its development fields, its
MDL_DATA tables (`ss_*_vox`) and boundary conditions (`dof_fixed`,
`external_*`) come across with it, and a state's plastic strain offset,
kinetic-energy ring and volume-effects carry (`ts_sum`, `cs_area`,
`cur_dt`) with the state. The tests use it to start both
packages from the same body and state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from evosoro_tpu_torch.core.collision import CollisionSystem
from evosoro_tpu_torch.core.types import DevoState, EnvParams, SimParams, SimState, VoxelBody
from evosoro_tpu_torch.envs.drag import MeshDragSystem, mesh_from_tables


def _tensor(v, device, dtype):
    a = np.array(v)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int32), device=device)
    return torch.as_tensor(a, device=device).to(dtype)


def _convert(cls, src, device, dtype, scalars=()):
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(src, f.name, None)
        if v is None or isinstance(v, (bool, str)):
            out[f.name] = v
        elif f.name in scalars:
            out[f.name] = float(np.asarray(v))
        elif isinstance(v, (int, float)):
            out[f.name] = v
        elif f.name == "collision":
            out[f.name] = collision_from_numpy(v)
        elif f.name == "mesh_drag":
            out[f.name] = mesh_drag_from_numpy(v, device, dtype)
        elif f.name == "devo":
            out[f.name] = _convert(DevoState, v, device, dtype)
        else:
            out[f.name] = _tensor(v, device, dtype)
    return cls(**out)


def body_from_numpy(body, device="cpu", dtype=torch.float32) -> VoxelBody:
    """A JAX `VoxelBody` (numpy leaves) as this port's VoxelBody."""
    return _convert(VoxelBody, body, device, dtype, scalars=("nominal_size",))


def state_from_numpy(state, device="cpu", dtype=torch.float32) -> SimState:
    """A JAX `SimState` (numpy leaves) as this port's SimState."""
    return _convert(SimState, state, device, dtype)


def collision_from_numpy(colsys) -> CollisionSystem:
    """A JAX `CollisionSystem` as this port's (numpy tables, as built)."""
    return CollisionSystem(
        surf_idx=np.asarray(colsys.surf_idx),
        surf_mask=np.asarray(colsys.surf_mask),
        pair_a1=np.asarray(colsys.pair_a1),
        allowed=np.asarray(colsys.allowed),
    )


def mesh_drag_from_numpy(sys, device="cpu", dtype=torch.float32) -> MeshDragSystem:
    """A JAX `MeshDragSystem` as this port's (tensors on `device`)."""
    return mesh_from_tables({f.name: np.asarray(getattr(sys, f.name))
                             for f in dataclasses.fields(MeshDragSystem)},
                            device=device, dtype=dtype)


def _params(cls, src):
    """Python values stay; a 0-d array becomes a float, an array of a batch
    shape (a leaf of stacked params, one value a robot) a tensor."""
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(src, f.name)
        if isinstance(v, (bool, int, float, str)) or v is None:
            out[f.name] = v
        else:
            a = np.array(v)  # a copy: the source may be read-only
            out[f.name] = float(a) if a.ndim == 0 else torch.as_tensor(a)
    return cls(**out)


def sim_params_from_jax(sim) -> SimParams:
    return _params(SimParams, sim)


def env_params_from_jax(env) -> EnvParams:
    """A JAX `EnvParams` as this port's; its sources come across as float64
    tensors."""
    sources = None
    if env.sources is not None:
        from evosoro_tpu_torch.envs.sources import EnvSources

        s = env.sources
        sources = EnvSources(
            base_pos=torch.as_tensor(np.asarray(s.base_pos, np.float64)),
            amp=torch.as_tensor(np.asarray(s.amp, np.float64)),
            freq=torch.as_tensor(np.asarray(s.freq, np.float64)),
            enabled=torch.as_tensor(np.asarray(s.enabled, bool)),
            source_type=torch.as_tensor(np.asarray(s.source_type, np.int32)))
    return _params(EnvParams, env.replace(sources=None)).replace(sources=sources)


def spatial_result_from_numpy(res, device="cpu", dtype=torch.float32):
    """A JAX `SpatialRolloutResult` (numpy leaves: its final state sharded
    over a mesh comes across gathered, as `np.asarray` of a sharded array
    gives it) as this port's `parallel.spatial.SpatialRolloutResult`. A
    batch-sharded state (`parallel.mesh.shard_batch`'s leaves gathered the
    same way) is `state_from_numpy`'s."""
    from evosoro_tpu_torch.parallel.spatial import SpatialRolloutResult

    return SpatialRolloutResult(
        final_state=state_from_numpy(res.final_state, device, dtype),
        **{k: _tensor(getattr(res, k), device, dtype)
           for k in ("ini_cm", "final_cm", "final_dist", "final_dist_y", "diverged")})
