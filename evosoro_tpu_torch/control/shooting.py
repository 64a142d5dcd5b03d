"""Shooting-method optimizers over the rollout actuation channel.

The port of `evosoro_tpu.control.shooting`. The decision variable is a control sequence `u` of shape (K, X, Y, Z): knot k
modulates every voxel's scale (a fraction of the nominal size) during steps
[k·S/K, (k+1)·S/K). Candidate batches are a leading batch dimension of the
rollout, so one card evaluates a whole population per solver iteration.

Two paths, as in the JAX package: `cem_optimize`, `grad_optimize` and
`mpc_run` go through the eager `core.rollout.rollout` (any feature of the
eager step, any cost; `grad_optimize` differentiates it with torch autograd);
`cem_optimize_fused` and `make_fused_mpc_closed_loop` go through the fused
rollout kernel K1 with its control-knot channel. Where JAX takes a PRNG key
these take a `torch.Generator` on the device they run on. The device is the
card unless the caller passes `device="cpu"`.

On the card a solve is a host loop that enqueues torch ops and one K1 launch
per CEM iteration without ever waiting for the device: elites are picked by
`argsort` and indexing on the device, and costs stay tensors until the solve
returns. So a solve is `num_iters` K1 launches. (The JAX package's "one
device program per solve" is a `lax.scan` under `jit`, and its solver caches
exist to reuse compiled programs; nothing compiles per shape here, so there
are no caches.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from evosoro_tpu_torch.core.rollout import init_state, rollout
from evosoro_tpu_torch.core.types import EnvParams, SimParams, SimState, VoxelBody
from evosoro_tpu_torch.device import resolve_device
from evosoro_tpu_torch.ops import fused_rollout as fr


def locomotion_cost(result) -> torch.Tensor:
    """Negative normalized CoM displacement (reference fitness:
    VX_SimGA.cpp:36 NormFinalDist); diverged rollouts cost 1e9."""
    return torch.where(result.diverged, 1e9, -result.norm_final_dist)


@dataclasses.dataclass(frozen=True)
class CEMConfig:
    num_iters: int = 8
    pop_size: int = 64
    elite_frac: float = 0.125
    init_std: float = 0.02  # scale modulation is a fraction of voxel size
    min_std: float = 1e-4
    smoothing: float = 0.5  # mean/std EMA across iterations
    u_clip: float = 0.2  # keep |u| within stable actuation range

    @property
    def n_elite(self) -> int:
        return max(1, int(self.pop_size * self.elite_frac))


@dataclasses.dataclass
class CEMState:
    """The sampling distribution and the best candidate so far, as tensors."""

    mean: Any  # (K, X, Y, Z)
    std: Any
    best_u: Any
    best_cost: Any  # scalar tensor

    @classmethod
    def initial(cls, mean0, std0):
        return cls(mean0, std0, mean0,
                   torch.full((), float("inf"), dtype=mean0.dtype,
                              device=mean0.device))


def _check_generator(generator, device):
    if not isinstance(generator, torch.Generator):
        raise TypeError("the solvers take a torch.Generator (where the JAX "
                        "package takes a PRNG key)")
    if generator.device.type != device.type:
        raise ValueError(f"the generator is on {generator.device}, the solve "
                         f"runs on {device}")


def cem_sample(generator, state: CEMState, pop: int, config: CEMConfig):
    """`pop` candidates from N(mean, std²), clipped to ±u_clip."""
    eps = torch.randn((pop,) + tuple(state.mean.shape), generator=generator,
                      dtype=state.mean.dtype, device=state.mean.device)
    us = state.mean[None] + state.std[None] * eps
    return torch.clamp(us, -config.u_clip, config.u_clip)


def cem_update(state: CEMState, us, costs, config: CEMConfig) -> CEMState:
    """One CEM refit from candidates `us` (P, K, X, Y, Z) and their `costs`
    (P,): elites by a stable sort (ties keep the lower index, as
    `jnp.argsort`), their mean and population deviation (`jnp.std`) blended
    into the distribution, and the running best. No host synchronisation."""
    order = torch.argsort(costs, stable=True)[:config.n_elite]
    elites = us[order]
    a = config.smoothing
    mean = a * elites.mean(0) + (1 - a) * state.mean
    std = a * (elites.std(0, correction=0) + config.min_std) + (1 - a) * state.std
    it_best = costs[order[0]]
    better = it_best < state.best_cost
    return CEMState(mean, std, torch.where(better, us[order[0]], state.best_u),
                    torch.minimum(state.best_cost, it_best))


def _cem_loop(generator, evaluate, state: CEMState, pop: int, config: CEMConfig):
    """`config.num_iters` iterations of sample, `evaluate(us) -> costs`,
    refit. Returns (final state, running-best trace, mean-cost trace)."""
    best_trace, mean_trace = [], []
    for _ in range(config.num_iters):
        us = cem_sample(generator, state, pop, config)
        costs = evaluate(us)
        state = cem_update(state, us, costs, config)
        best_trace.append(state.best_cost)
        mean_trace.append(costs.mean())
    return state, torch.stack(best_trace), torch.stack(mean_trace)


def _info(best_cost, best_trace, mean_trace, mean, std):
    return dict(best_cost=best_cost, best_cost_trace=best_trace,
                mean_cost_trace=mean_trace, final_mean=mean, final_std=std)


def cem_optimize(
    generator,
    body: VoxelBody,
    sim: SimParams,
    env: EnvParams,
    num_steps: int,
    num_knots: int,
    config: CEMConfig = CEMConfig(),
    state0: SimState | None = None,
    dt=None,
    cost_fn: Callable = locomotion_cost,
    init_mean=None,
    device=None,
):
    """Cross-Entropy Method over control sequences through the eager
    `rollout`: the general path (any feature of the eager step, any
    `cost_fn` of a `RolloutResult`). Returns (best_u, info)."""
    device = resolve_device(device)
    _check_generator(generator, device)
    body = body.to(device)
    state0 = (init_state(body, volume_effects=sim.volume_effects_enabled)
              if state0 is None else state0.to(device))
    shape = (num_knots,) + tuple(body.occ.shape[-3:])
    dtype = body.nom_pos.dtype
    mean0 = (torch.zeros(shape, dtype=dtype, device=device) if init_mean is None
             else torch.as_tensor(init_mean, dtype=dtype, device=device))
    std0 = torch.full(shape, config.init_std, dtype=dtype, device=device)

    def evaluate(us):
        return cost_fn(rollout(body, sim, env, num_steps=num_steps, dt=dt,
                               state=state0, control_sequence=us))

    final, best_trace, mean_trace = _cem_loop(
        generator, evaluate, CEMState.initial(mean0, std0), config.pop_size,
        config)
    return final.best_u, _info(final.best_cost, best_trace, mean_trace,
                               final.mean, final.std)


def grad_optimize(
    body: VoxelBody,
    sim: SimParams,
    env: EnvParams,
    num_steps: int,
    num_knots: int,
    num_iters: int = 50,
    lr: float = 1e-3,
    state0: SimState | None = None,
    dt=None,
    cost_fn: Callable = locomotion_cost,
    init_u=None,
    device=None,
):
    """First-order shooting: Adam on the rollout cost by backpropagation
    through time (torch autograd through the eager `rollout`; `torch.optim.Adam`
    at its defaults b1 0.9, b2 0.999, eps 1e-8, which are `optax.adam`'s).
    Contact nonsmoothness can make this landscape rough: CEM is the robust
    default, this is the refinement pass. Returns (u, info) with the cost
    before each update in `cost_trace`."""
    device = resolve_device(device)
    body = body.to(device)
    state0 = (init_state(body, volume_effects=sim.volume_effects_enabled)
              if state0 is None else state0.to(device))
    shape = (num_knots,) + tuple(body.occ.shape[-3:])
    dtype = body.nom_pos.dtype
    u = (torch.zeros(shape, dtype=dtype, device=device) if init_u is None
         else torch.as_tensor(init_u, dtype=dtype, device=device).clone())
    u.requires_grad_(True)
    opt = torch.optim.Adam([u], lr=lr)
    costs = []
    for _ in range(num_iters):
        opt.zero_grad()
        with torch.enable_grad():
            c = cost_fn(rollout(body, sim, env, num_steps=num_steps, dt=dt,
                                state=state0, control_sequence=u))
        c.backward()
        opt.step()
        costs.append(c.detach())
    cs = torch.stack(costs)
    return u.detach(), dict(cost_trace=cs, final_cost=cs[-1])


def _fused_costs(packed, call_kwargs, L, us):
    """Costs of candidates `us` (P, K, X, Y, Z) through one K1 launch on the
    packed (state, body, stats, pair table)."""
    state_packed, body_packed, stats, coll = packed
    P, K = us.shape[:2]
    out_state, out_stats = fr.fused_call(
        state_packed, body_packed, stats, coll,
        control_packed=fr._flat(us, (P, K)).contiguous(), **call_kwargs)
    m = fr.packed_metrics(out_state, body_packed, out_stats, L)
    return torch.where(m["diverged"], 1e9, -m["norm_final_dist"])


def _sharded_costs(packed, call_kwargs, L, mesh, spans):
    """`_fused_costs` with the candidates split over `mesh` (a
    `parallel.mesh.Mesh`) in the row `spans`: one K1 launch a shard on its
    device, each shard's packed rows (and the tables shared by every
    candidate) copied there once, the launches issued before any cost is
    read (`parallel.mesh.run_shards`); the costs gathered on the first
    entry's device."""
    from evosoro_tpu_torch.parallel.mesh import run_shards

    P = packed[0].shape[0]

    def part(t, lo, hi, d):
        if t is None:
            return None
        return (t[lo:hi] if t.shape[0] == P else t).to(d).contiguous()

    shards = {(lo, hi, d): (tuple(part(t, lo, hi, d) for t in packed),
                            {key: part(v, lo, hi, d) if torch.is_tensor(v) else v
                             for key, v in call_kwargs.items()})
              for (lo, hi), d in zip(spans, mesh)}

    def costs(us):
        def one(lo, hi, d):
            shard_packed, shard_kwargs = shards[lo, hi, d]
            return _fused_costs(shard_packed, shard_kwargs, L, us[lo:hi].to(d))

        return torch.cat(run_shards(one, spans, mesh, fetch=lambda c: c.to(mesh[0])))

    return costs


def plan_inputs(state, stats, pop: int):
    """The packed (state, stats) a closed-loop plan launches on: row 0 of the
    true state broadcast to `pop` candidates, with the CoM capture reset so
    the plan scores its own window."""
    plan_state = state[:1].expand(pop, -1, -1).contiguous()
    plan_stats = stats[:1].expand(pop, -1).clone()
    plan_stats[:, fr._S_CAPT] = 0.0
    return plan_state, plan_stats


def make_fused_cem_solver(runner: fr.FusedBatchRunner, num_knots: int,
                          grid_shape, config: CEMConfig = CEMConfig(),
                          mesh=None):
    """A CEM solve over the fused rollout kernel on a runner's launch
    settings: every iteration is one K1 launch over the candidate batch
    (`runner.batch` candidates), with sampling, the cost reduction and the
    elite update as device ops around it. The packed tensors ride as
    arguments, so one solver serves any state of the same design. Returns
    `solve(generator, packed, mean0, std0) -> (best_u, best_cost,
    best_trace, mean_trace, mean, std)` with `packed = (state, body, stats,
    pair table)`; everything returned is a tensor on the device.

    `mesh` (a `parallel.mesh.Mesh` or a list of devices, which may repeat
    one; the runner's device by default): the candidates are split over its
    entries, one K1 launch a shard on its device, the costs gathered on the
    first entry's device, where the sampling (from the caller's generator)
    and the elite update run once; so the solve returns the unsharded
    solve's `best_u` bit for bit. The batch must divide by the mesh's size.
    The entries must be devices of the runner's type."""
    from evosoro_tpu_torch.parallel.mesh import as_mesh, check_mesh, row_spans

    if (num_knots,) + tuple(grid_shape) != (runner.num_knots,) + runner.grid_shape:
        raise ValueError("the solver's knots and grid differ from the runner's")
    call_kwargs = dict(runner.call_kwargs)
    L, P = float(runner.L), runner.batch
    device = runner.state_packed.device
    mesh = check_mesh(as_mesh([device] if mesh is None else mesh), device)
    spans = row_spans(P, len(mesh))

    def solve(generator, packed, mean0, std0):
        costs = _sharded_costs(packed, call_kwargs, L, mesh, spans)
        final, best_trace, mean_trace = _cem_loop(
            generator, costs, CEMState.initial(mean0, std0), P, config)
        return (final.best_u, final.best_cost, best_trace, mean_trace,
                final.mean, final.std)

    return solve


def cem_optimize_fused(
    generator,
    body: VoxelBody,
    sim: SimParams,
    env: EnvParams,
    num_steps: int,
    num_knots: int,
    config: CEMConfig = CEMConfig(),
    dt=None,
    state0: SimState | None = None,
    stop_time=None,
    mesh=None,
    device=None,
):
    """CEM over control sequences through the fused rollout kernel: the
    production MPC solve. `config.num_iters` K1 launches of `pop_size`
    candidates, nothing waiting on the device until the solve returns.
    Same semantics as `cem_optimize`. Returns (best_u, info); `best_cost`
    is a float. `mesh` spreads the candidate launches over devices
    (`make_fused_cem_solver`), the population rounded up to a multiple of
    8 x the mesh's size (the JAX package's quantum); `device` is where the
    sampling and the elite update run, and the mesh's first entry
    should be it."""
    device = resolve_device(device)
    _check_generator(generator, device)
    body = body.to(device)
    pop = config.pop_size
    if mesh is not None:
        from evosoro_tpu_torch.parallel.mesh import as_mesh

        quantum = 8 * len(as_mesh(mesh))
        pop = -(-pop // quantum) * quantum
    runner = fr.FusedBatchRunner(
        body, sim, env, batch=pop, num_steps=num_steps,
        num_knots=num_knots, dt=dt,
        state=None if state0 is None else state0.to(device),
        stop_time=stop_time)
    shape = (num_knots,) + runner.grid_shape
    solve = make_fused_cem_solver(runner, num_knots, runner.grid_shape, config,
                                  mesh=mesh)
    mean0 = torch.zeros(shape, dtype=torch.float32, device=device)
    std0 = torch.full(shape, config.init_std, dtype=torch.float32, device=device)
    packed = (runner.state_packed, runner.body_packed, runner.stats,
              runner.collision_packed)
    best_u, best_cost, best_trace, mean_trace, mean, std = solve(
        generator, packed, mean0, std0)
    # the solve's one wait for the device
    return best_u, _info(float(best_cost), best_trace, mean_trace, mean, std)


def make_fused_mpc_closed_loop(body, sim, env, plan_steps, plan_knots,
                               exec_knots=1, config: CEMConfig = CEMConfig(),
                               dt=None, device=None):
    """Receding-horizon MPC through the fused rollout kernel: every segment
    plans a `plan_steps` window with a warm-started CEM (`config.num_iters`
    launches of `config.pop_size` candidates from the current true state,
    the mean carried over from the previous plan shifted by the executed
    knots), then executes the first `exec_knots` knots on the true state
    with one more launch. The executed launch is not segmented: each
    executed segment restarts its knot clock.

    Returns `(run, aux)`: `run(generator, n_segments, state, stats, mean0,
    std0)` returns `(state, stats, planned_cost_per_segment)`. The true
    state is a batch of ONE robot: `aux["state"]` (1, C_S, V) and
    `aux["stats"]` (1, C_STAT) are its packed initial values; `aux` also
    carries the knot shape, `exec_steps`, the population `P`, `cm_xy`, the
    runner, and the keyword arguments of the loop's two K1 launches
    (`plan_kwargs`, `exec_kwargs`). Real-time factor = executed seconds per
    device second."""
    device = resolve_device(device)
    body = body.to(device)
    steps_per_knot = plan_steps // plan_knots
    exec_steps = steps_per_knot * exec_knots
    P = config.pop_size
    runner = fr.FusedBatchRunner(body, sim, env, batch=P, num_steps=plan_steps,
                                 num_knots=plan_knots, dt=dt)
    plan_kwargs = dict(runner.call_kwargs)
    exec_kwargs = dict(plan_kwargs, num_steps=exec_steps, n_knots=exec_knots)
    L = float(runner.L)
    shape = (plan_knots,) + runner.grid_shape
    body_packed, coll = runner.body_packed, runner.collision_packed

    def run(generator, n_segments, state, stats, mean0, std0):
        _check_generator(generator, device)
        mean, std = mean0, std0
        costs = []
        for _ in range(n_segments):
            # plan from the current true state
            plan_state, plan_stats = plan_inputs(state, stats, P)
            packed = (plan_state, body_packed, plan_stats, coll)
            best, _, _ = _cem_loop(
                generator, lambda us: _fused_costs(packed, plan_kwargs, L, us),
                CEMState.initial(mean, std), P, config)
            # execute the first exec_knots on the true state
            u_exec = best.best_u[:exec_knots]
            state, stats = fr.fused_call(
                state, body_packed, stats, coll,
                control_packed=fr._flat(u_exec[None], (1, exec_knots)).contiguous(),
                **exec_kwargs)
            # warm start the next plan: shift out the executed knots
            mean = torch.cat([best.best_u[exec_knots:],
                              best.best_u[-1:].expand((exec_knots,) + shape[1:])])
            std = torch.full(shape, config.init_std, dtype=torch.float32,
                             device=device)
            costs.append(best.best_cost)
        return state, stats, torch.stack(costs)

    mass = body_packed[:, fr._B_MASS, :]

    def cm_xy(state, stats):
        inv_m = stats[0, fr._S_INV_MASS]
        return torch.stack([(state[0, fr._POS + c, :] * mass[0]).sum() * inv_m
                            for c in range(2)])

    aux = dict(state=runner.state_packed[:1].clone(),
               stats=runner.stats[:1].clone(), shape=shape,
               exec_steps=exec_steps, P=P, cm_xy=cm_xy, runner=runner,
               plan_kwargs=plan_kwargs, exec_kwargs=exec_kwargs)
    return run, aux


@dataclasses.dataclass(frozen=True)
class MPCController:
    """Receding-horizon planner: CEM over a short lookahead, execute the
    first `execute_knots` segment, warm-start the next plan by shifting."""

    body: VoxelBody
    sim: SimParams
    env: EnvParams
    dt: Any
    plan_steps: int  # lookahead rollout length (steps)
    plan_knots: int
    execute_knots: int = 1
    config: CEMConfig = CEMConfig()
    cost_fn: Callable = locomotion_cost

    def plan(self, generator, state: SimState, warm_start=None, device=None):
        return cem_optimize(
            generator, self.body, self.sim, self.env, self.plan_steps,
            self.plan_knots, self.config, state0=state, dt=self.dt,
            cost_fn=self.cost_fn, init_mean=warm_start, device=device)


def mpc_run(generator, controller: MPCController, total_segments: int,
            device=None):
    """Closed-loop MPC through the eager rollout: plan, execute, advance the
    true state, per segment. Returns (final_state, executed_controls,
    per-segment planned costs)."""
    device = resolve_device(device)
    body = controller.body.to(device)
    sim, env, dt = controller.sim, controller.env, controller.dt
    steps_per_knot = controller.plan_steps // controller.plan_knots
    ek = controller.execute_knots
    exec_steps = steps_per_knot * ek

    state = init_state(body, volume_effects=sim.volume_effects_enabled)
    warm = None
    executed, costs = [], []
    for _ in range(total_segments):
        u, info = controller.plan(generator, state, warm_start=warm,
                                  device=device)
        u_exec = u[:ek]
        state = rollout(body, sim, env, num_steps=exec_steps, dt=dt,
                        state=state, control_sequence=u_exec).final_state
        executed.append(u_exec)
        costs.append(info["best_cost"])
        # shift the plan for the warm start: drop the executed knots, repeat
        # the tail
        warm = torch.cat([u[ek:], u[-1:].expand((ek,) + tuple(u.shape[1:]))])
    return state, torch.cat(executed), torch.stack(costs)
