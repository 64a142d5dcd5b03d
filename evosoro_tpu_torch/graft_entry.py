"""Entry points of the port: a one-device step check and a several-device
dry run, the twins of the JAX package's `__graft_entry__.entry` and
`dryrun_multichip`.

`entry()` returns the flagship workload's forward step — one physics
timestep of a batch of soft robots (the hot path of every rollout,
reference: VX_Sim.cpp:1763 Integrate) — as a function and its arguments.

`dryrun_multichip(n)` runs, over n entries of a device list (a mesh,
`parallel.mesh`, which may name one card n times): one step of the batch
sharded over the entries with a CoM reduction across them, a spatial
rollout of one robot cut into n slabs (`parallel.spatial`), a K1 rollout
sharded over the entries (`parallel.mesh.sharded_fused_rollout`) and a
generation of the basic experiment sharded over them
(`evo.evaluation.evaluate_all(devices=)`), each checked finite.
"""

from __future__ import annotations

import numpy as np
import torch

from evosoro_tpu_torch.device import resolve_device


def _make_batch(batch: int, nx: int = 6, ny: int = 6, nz: int = 6, device="cpu"):
    from evosoro_tpu_torch.core import (
        EnvParams,
        SimParams,
        build_body,
        calc_max_dt,
        evosoro_default_palette,
        init_state,
        palette_from_list,
    )
    from evosoro_tpu_torch.parallel.mesh import tree_map

    rng = np.random.default_rng(0)
    structure = rng.integers(0, 5, size=(nx, ny, nz)).astype(np.int32)
    structure[nx // 2, ny // 2, nz // 2] = 3  # ensure nonempty
    phase = rng.uniform(-1, 1, size=(nx, ny, nz))
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=phase).to(device)
    sim, env = SimParams(), EnvParams()
    dt = float(calc_max_dt(body)) * sim.dt_frac
    state = tree_map(lambda x: x.expand((batch,) + x.shape).clone(), init_state(body))
    return state, body, sim, env, dt


def entry(device=None):
    """(fn, example_args): the batched forward physics step on `device` (the
    card unless the caller names the CPU)."""
    from evosoro_tpu_torch.core.step import sim_step

    batched_state, body, sim, env, dt = _make_batch(8, device=resolve_device(device))

    def forward(state_batch):
        return sim_step(state_batch, body, sim, env, dt)

    return forward, (batched_state,)


def _devices(n_devices: int, devices):
    if devices is not None:
        return list(devices)[:n_devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: pass devices= (for example "
                           '["cpu"] * n) to run the dry run on the CPU')
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n_devices)]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One sharded step, a spatial rollout, a sharded K1 rollout and a
    sharded generation over `n_devices` entries of `devices` (every visible
    card in turn by default, one card repeated if there is only one).
    Returns what each part produced; raises if anything is not finite."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.core import (
        EnvParams,
        SimParams,
        build_body,
        calc_max_dt,
        evosoro_default_palette,
        init_state,
        palette_from_list,
    )
    from evosoro_tpu_torch.core.rollout import center_of_mass
    from evosoro_tpu_torch.core.step import sim_step
    from evosoro_tpu_torch.evo import evaluation
    from evosoro_tpu_torch.parallel.mesh import (
        Mesh,
        run_sharded,
        sharded_fused_rollout,
        tree_map,
    )
    from evosoro_tpu_torch.parallel.spatial import spatial_rollout

    mesh = Mesh(tuple(_devices(n_devices, devices)))
    out = {}

    # the batch sharded over the entries, one step each, and a fitness
    # reduction across them (the CoM of every robot, gathered, then a mean)
    batch = 2 * n_devices
    state, body, sim, env, dt = _make_batch(batch, 4, 4, 4, device=mesh[0])

    def step_and_cm(s, b):
        new = sim_step(s, b, sim, env, dt)
        return new, center_of_mass(new, b)

    _, cms = run_sharded(step_and_cm, state, mesh, body)
    out["mean_cm"] = cms.mean(0)
    _finite(out["mean_cm"], "CoM in dryrun")

    # spatial model parallelism: one robot's lattice cut into n slabs
    rng = np.random.default_rng(1)
    X = 2 * n_devices
    structure = rng.integers(0, 5, size=(X, 3, 3)).astype(np.int32)
    structure[:, 1, 0] = 3  # connected spine
    palette = palette_from_list(evosoro_default_palette())
    body2 = build_body(structure, palette, phase_offset=rng.uniform(-1, 1, size=(X, 3, 3)))
    sim2 = SimParams()
    res = spatial_rollout(body2.to(mesh[0]), sim2, EnvParams(), num_steps=3,
                          dt=float(calc_max_dt(body2)) * sim2.dt_frac, mesh=mesh)
    out["spatial_final_cm"] = res.final_cm
    _finite(res.final_cm, "CoM in spatial dryrun")

    # K1 over the batch axis, one launch an entry
    structure3 = rng.integers(0, 5, size=(4, 4, 4)).astype(np.int32)
    structure3[2, 2, 0] = 3
    body3 = build_body(structure3, palette,
                       phase_offset=rng.uniform(-1, 1, size=(4, 4, 4))).to(mesh[0])
    B3 = 8 * n_devices
    st3 = tree_map(lambda x: x.expand((B3,) + x.shape).clone(), init_state(body3))
    fstate, _ = sharded_fused_rollout(st3, body3, sim2, EnvParams(), num_steps=2,
                                      dt=float(calc_max_dt(body3)) * sim2.dt_frac, mesh=mesh)
    out["fused_pos"] = fstate.pos
    _finite(fstate.pos, "state in sharded K1 dryrun")

    # the evolution's generation, each launch sharded over the entries
    sim4, env4, pop = bench.basic_experiment(pop_size=8 * n_devices, sim_time=0.002,
                                             init_time=0.001, size=(4, 4, 4))
    evaluation.evaluate_all(sim4, env4, pop, devices=list(mesh))
    out["fitness"] = np.array([ind.fitness for ind in pop])
    out["n_shards"] = evaluation.LAST_DISPATCH_TIMING["n_shards"]
    _finite(torch.as_tensor(out["fitness"]), "fitness in sharded evaluator dryrun")
    return out


def _finite(t, what: str):
    if not bool(torch.isfinite(t).all()):
        raise RuntimeError(f"non-finite {what}")


if __name__ == "__main__":
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    print("entry() OK")
