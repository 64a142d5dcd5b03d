"""Benchmarks of the port on one card.

Four workloads, all from the JAX package's own benchmarks:

- throughput: the root `bench.py` workload on the port: B concurrent 10³
  robots (`default_rng(0)`, material ids 1..4, random phase offsets) with
  thermal actuation, floor contact and gravity at `SimParams()` defaults,
  through one fused-rollout launch; reported as occupied voxel-steps per
  second;
- evolution: the `examples/basic.py` experiment (CPPN material tree, AFPO
  Pareto optimization of NormFinalDist vs age) at the `EVOBENCH.json`
  "basic" configuration: pop 15, 6³, 5 s of sim time, self-collision on;
- mpc: the `tools/bench_mpc.py` workload: one cold CEM solve over the 10³
  bench design (6 iterations x 128 candidates x 200 steps, 8 knots) through
  `cem_optimize_fused`, then a closed receding-horizon loop through
  `make_fused_mpc_closed_loop` (warm replans of 1 x 32 candidates, 4 of 8
  knots executed a segment);
- sqp: the gradient-MPC part of `tools/bench_mpc.py`: `FusedSQPSolver` on
  the same design without floor and gravity, 200 plan steps in 8 segments,
  8 knots, 4 Gauss-Newton iterations: one cold solve and re-plans from its
  result with moving targets, through K1 forward and the reverse-mode
  segment kernel B4 backward.

Run:  python -m evosoro_tpu_torch.bench [--batch 1024] [--steps 200]
      [--gens 2] [--segments 4]
      (needs a CUDA device; prints one JSON line per result)
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import tempfile
import time
from functools import partial

import numpy as np
import torch

from evosoro_tpu_torch import roofline
from evosoro_tpu_torch.control.shooting import (
    CEMConfig,
    cem_optimize_fused,
    make_fused_cem_solver,
    make_fused_mpc_closed_loop,
)
from evosoro_tpu_torch.control.sqp import FusedSQPSolver, SQPConfig
from evosoro_tpu_torch.core.collision import build_collision_system
from evosoro_tpu_torch.core.materials import build_body, calc_max_dt, palette_from_list
from evosoro_tpu_torch.core.rollout import init_state
from evosoro_tpu_torch.core.types import EnvParams, SimParams, evosoro_default_palette
from evosoro_tpu_torch.evo import evaluation
from evosoro_tpu_torch.evo.algorithms import ParetoOptimization
from evosoro_tpu_torch.evo.base import Env, ObjectiveDict, Sim
from evosoro_tpu_torch.evo.networks import CPPN
from evosoro_tpu_torch.evo.softbot import Genotype, Phenotype, Population
from evosoro_tpu_torch.ops import fused_rollout as fr
from evosoro_tpu_torch.utils.functional import count_occurrences
from evosoro_tpu_torch.utils.phenotype_mappers import make_material_tree


def card_info() -> str:
    """`nvidia-smi`'s name and power limit of the cards, as it prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def bench_body(n=10, seed=0, device="cpu"):
    """The bench.py design: an n³ block of material ids 1..4 with random
    phase offsets, built from `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    structure = rng.integers(1, 5, size=(n, n, n)).astype(np.int32)
    phase = rng.uniform(-1, 1, size=(n, n, n))
    palette = palette_from_list(evosoro_default_palette())
    body = build_body(structure, palette, phase_offset=phase, device=device)
    return structure, body


def packed_workload(batch, n=10, collision=False, device="cuda"):
    """Packed (state, body, stats, pair table) of `batch` copies of the
    bench design at rest, plus the launch's keyword arguments."""
    structure, body = bench_body(n, device=device)
    sim = SimParams(self_collisions_enabled=collision)
    env = EnvParams()
    dt = calc_max_dt(body) * sim.dt_frac
    state = fr.pack_state_single(init_state(body))
    state = state[None].expand(batch, -1, -1).contiguous()
    body_packed = fr.pack_body(body)
    stats = fr.make_stats(body, batch, dt, sim, env)
    table = None
    if collision:
        cs = build_collision_system(structure, body.e_mod.cpu().numpy(), 0.01)
        table = torch.as_tensor(fr.pack_collision(cs, (n, n, n)), device=device)[None]
    kw = dict(grid_shape=(n, n, n),
              scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=dict(fr.kernel_env_flags(sim, env), **fr.body_flags(body),
                         collision=collision))
    return (state, body_packed, stats, table), kw, int(body.occ.sum())


def evaluator_workload(pop_size=15, collision=True, stagger=False, seed=1,
                       device="cuda"):
    """The packed (state, body, stats, pair table) that the evolution
    evaluator gives K1 for the first generation of the basic experiment:
    `pop_size` random 6³ designs, each with its own body, pair table and dt,
    padded up the batch ladder. Designs of one step bucket mostly share a
    dt, so `stagger` gives each robot its own dt (up to 25 % below its
    stable one) and moves its stop time and IniCM time to its own step
    within the first 100, so the freeze and the capture land on different
    steps per robot. Returns (args, launch keywords without num_steps)."""
    sim, env, pop = basic_experiment(pop_size=pop_size, seed=seed)
    sim.self_collisions_enabled = collision
    fn, inputs = evaluation.evaluator_batch(sim, env, list(pop), device=device)
    state, body, stats, table = fn.pack(*inputs)
    if stagger:
        i = torch.arange(stats.shape[0], device=stats.device, dtype=stats.dtype)
        dt = stats[:, fr._S_DT] * (1.0 - i / (4 * stats.shape[0]))
        stats[:, fr._S_DT] = dt
        stats[:, fr._S_STOP] = dt * ((i * 37) % 97 + 3.5)
        stats[:, fr._S_INITCM] = dt * ((i * 53) % 89 + 0.5)
    kw = {k: v for k, v in fn.launch_kw.items() if k != "num_steps"}
    return (state, body, stats, table), kw


def time_call(fn, groups=4, reps=3):
    """Best per-call milliseconds over `groups` groups of `reps` calls,
    timed with CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


def throughput(batch=1024, steps=200, collision=False, plain=False,
               groups=4, reps=3, device="cuda"):
    """Voxel-steps per second of one fused-rollout call on the bench
    workload, beside the least time the card could take for it
    (`roofline.bound`); `plain` times K1's plain version on the same
    tensors."""
    args, kw, n_occ = packed_workload(batch, collision=collision, device=device)
    call = fr.fused_rollout_plain if plain else fr.fused_call
    ms = time_call(lambda: call(*args, num_steps=steps, **kw), groups, reps)
    _, stats_out = call(*args, num_steps=steps, **kw)
    least = roofline.bound(*roofline.k1_work(*args, stats_out))
    return dict(batch=batch, steps=steps, collision=collision,
                impl="plain" if plain else "K1", ms=ms,
                voxel_steps_per_s=n_occ * batch * steps / (ms * 1e-3),
                bound_ms=least["bound_ms"], bound_by=least["bound_by"])


# ---------------------------------------------------------------------------
# Sampling MPC (tools/bench_mpc.py)
# ---------------------------------------------------------------------------


def mpc_workload(n=10, seed=0, device="cuda"):
    """(body, sim, env, dt) of the MPC benchmark: the bench design with
    actuation and the CoM capture from time 0."""
    _, body = bench_body(n, seed=seed, device=device)
    sim = SimParams(init_cm_time=0.0)
    return body, sim, EnvParams(), float(calc_max_dt(body) * sim.dt_frac)


def _timed_ms(fn, device):
    """(result, milliseconds, clock) of one call: CUDA events on the card,
    the host's clock on the CPU (a rehearsal's time, not a device time)."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0), "host clock, cpu"
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b), "cuda events"


def mpc(device="cuda", n=10, plan_steps=200, knots=8, num_iters=6, pop_size=128,
        warm_iters=1, warm_pop=32, exec_knots=4, segments=4, reps=3, seed=0):
    """The MPC benchmark on `device`. Returns a dict with two records:
    `solve` (the cold CEM solve: cost traces, K1 launches per solve,
    milliseconds per solve over `reps` solves on a prepared runner, solves
    per second) and `closed_loop` (`segments` plan-and-execute segments:
    planned costs, K1 launches, milliseconds per segment, executed NormDist
    and the real-time factor, executed seconds per second of `clock`)."""
    body, sim, env, dt = mpc_workload(n, seed, device)
    cfg = CEMConfig(num_iters=num_iters, pop_size=pop_size)
    gen = torch.Generator(device=device).manual_seed(seed)

    # one-off API path: packs the body, runs the solve, returns the plan
    k1 = fr.FUSED_ROLLOUT_LAUNCHES
    u, info = cem_optimize_fused(gen, body, sim, env, num_steps=plan_steps,
                                 num_knots=knots, config=cfg, dt=dt, device=device)
    launches = fr.FUSED_ROLLOUT_LAUNCHES - k1

    # the receding-horizon pattern: runner and solver built once
    runner = fr.FusedBatchRunner(body, sim, env, batch=pop_size,
                                 num_steps=plan_steps, num_knots=knots, dt=dt)
    solve = make_fused_cem_solver(runner, knots, runner.grid_shape, cfg)
    packed = (runner.state_packed, runner.body_packed, runner.stats,
              runner.collision_packed)
    shape = (knots,) + runner.grid_shape
    mean0 = torch.zeros(shape, dtype=torch.float32, device=device)
    std0 = torch.full(shape, cfg.init_std, dtype=torch.float32, device=device)
    solve(gen, packed, mean0, std0)
    _, ms, clock = _timed_ms(
        lambda: [solve(gen, packed, mean0, std0) for _ in range(reps)], device)
    solve_ms = ms / reps
    solve_rec = dict(
        n=n, plan_steps=plan_steps, knots=knots, num_iters=num_iters,
        pop_size=pop_size, rollouts_per_solve=num_iters * pop_size,
        k1_launches_per_solve=launches, ms_per_solve=solve_ms, clock=clock,
        solves_per_s=1e3 / solve_ms, horizon_s=plan_steps * dt,
        realtime_factor=plan_steps * dt / (solve_ms * 1e-3),
        best_cost=info["best_cost"],
        best_cost_trace=info["best_cost_trace"].tolist(),
        mean_cost_trace=info["mean_cost_trace"].tolist(),
        max_abs_u=float(u.abs().max()), u_clip=cfg.u_clip)

    cfg_w = CEMConfig(num_iters=warm_iters, pop_size=warm_pop,
                      init_std=cfg.init_std)
    run, aux = make_fused_mpc_closed_loop(
        body, sim, env, plan_steps, knots, exec_knots=exec_knots, config=cfg_w,
        dt=dt, device=device)
    args = (aux["state"], aux["stats"], u.to(torch.float32), std0)
    run(gen, 1, *args)  # warm-up
    k1 = fr.FUSED_ROLLOUT_LAUNCHES
    (state, stats, costs), ms, clock = _timed_ms(
        lambda: run(gen, segments, *args), device)
    seg_ms = ms / segments
    exec_s = aux["exec_steps"] * dt
    disp = torch.linalg.norm(aux["cm_xy"](state, stats)
                             - aux["cm_xy"](aux["state"], aux["stats"]))
    closed_rec = dict(
        warm_iters=warm_iters, warm_pop=warm_pop, exec_knots=exec_knots,
        exec_steps=aux["exec_steps"], segments=segments,
        k1_launches=fr.FUSED_ROLLOUT_LAUNCHES - k1, ms_per_segment=seg_ms,
        clock=clock, exec_horizon_s=exec_s,
        realtime_factor=exec_s / (seg_ms * 1e-3),
        planned_costs=costs.tolist(),
        executed_norm_dist=float(disp) / body.nominal_size,
        final_time=float(stats[0, fr._S_TIME]),
        expected_time=segments * aux["exec_steps"] * dt,
        diverged=bool((stats[:, fr._S_DIV] > 0.5).any()))
    return dict(solve=solve_rec, closed_loop=closed_rec)


# ---------------------------------------------------------------------------
# Gradient MPC (tools/bench_mpc.py, the SQP part)
# ---------------------------------------------------------------------------


def sqp(device="cuda", n=10, plan_steps=200, knots=8, n_res=8, num_iters=4,
        cg_iters=5, replans=3, seed=0):
    """The fused-SQP benchmark on `device`: one cold `FusedSQPSolver.solve`
    (target 0.4 lattice units of CoM-y travel) and `replans` warm re-plans
    from its result with targets `0.4 + 0.01 r`, without floor and gravity
    as in `tools/bench_mpc.py`. Returns the cold solve's cost traces and
    launch counts, and milliseconds per re-plan."""
    body, sim, _, dt = mpc_workload(n, seed, device)
    env = EnvParams(gravity_enabled=False, floor_enabled=False)
    cfg = SQPConfig(num_iters=num_iters, cg_iters=cg_iters, n_res=n_res)
    solver = FusedSQPSolver(body, sim, env, plan_steps, knots, config=cfg,
                            dt=dt, n_res=n_res, device=device)
    k1, b4 = fr.FUSED_ROLLOUT_LAUNCHES, fr.FUSED_BWD_LAUNCHES
    (u, info), cold_ms, clock = _timed_ms(lambda: solver.solve(target=0.4), device)
    k1, b4 = fr.FUSED_ROLLOUT_LAUNCHES - k1, fr.FUSED_BWD_LAUNCHES - b4

    def replan():
        v, out = u, []
        for r in range(replans):
            v, inf = solver.solve(target=0.4 + 0.01 * r, init_u=v)
            out.append(inf["final_cost"])
        return torch.stack(out)

    replan_costs, ms, _ = _timed_ms(replan, device)
    solve_ms = ms / max(replans, 1)
    return dict(
        n=n, plan_steps=plan_steps, knots=knots, n_res=n_res,
        num_iters=num_iters, seg_steps=solver.seg_steps,
        k1_launches_per_solve=k1, b4_launches_per_solve=b4,
        cold_solve_ms=cold_ms, ms_per_solve=solve_ms, clock=clock,
        solves_per_s=1e3 / solve_ms, horizon_s=plan_steps * dt,
        cost_trace=info["cost_trace"].tolist(),
        accepted_trace=info["accepted_trace"].tolist(),
        best_cost=float(info["best_cost"]), final_cost=float(info["final_cost"]),
        lm_lambda=float(info["lm_lambda"]), replan_final_costs=replan_costs.tolist(),
        max_abs_u=float(u.abs().max()), u_clip=cfg.u_clip)


# ---------------------------------------------------------------------------
# The examples/basic.py experiment
# ---------------------------------------------------------------------------

BASIC_IND_SIZE = (6, 6, 6)  # examples/basic.py IND_SIZE


class BasicGenotype(Genotype):
    """One CPPN whose four outputs form the material decision tree
    (examples/basic.py MyGenotype)."""

    def __init__(self):
        super().__init__(orig_size_xyz=BASIC_IND_SIZE)
        names = ["shape", "muscleOrTissue", "muscleType", "tissueType"]
        self.add_network(CPPN(output_node_names=names))
        m = self.to_phenotype_mapping
        m.add_map(name="material", tag="<Data>", func=make_material_tree,
                  dependency_order=names, output_type=int)
        m.add_output_dependency(name="shape", dependency_name=None,
                                requirement=None, material_if_true=None,
                                material_if_false="0")
        m.add_output_dependency(name="muscleOrTissue", dependency_name="shape",
                                requirement=True, material_if_true=None,
                                material_if_false=None)
        m.add_output_dependency(name="tissueType", dependency_name="muscleOrTissue",
                                requirement=False, material_if_true="1",
                                material_if_false="2")
        m.add_output_dependency(name="muscleType", dependency_name="muscleOrTissue",
                                requirement=True, material_if_true="3",
                                material_if_false="4")


class BasicPhenotype(Phenotype):
    """Validity: >= 30% full, >= 10% muscle (examples/basic.py MyPhenotype)."""

    def is_valid(self, min_percent_full=0.3, min_percent_muscle=0.1):
        for name, details in self.genotype.to_phenotype_mapping.items():
            if np.isnan(details["state"]).any():
                return False
            if name == "material":
                state = details["state"]
                n = np.prod(self.genotype.orig_size_xyz)
                if np.sum(state > 0) < n * min_percent_full:
                    return False
                if count_occurrences(state, [3, 4]) < n * min_percent_muscle:
                    return False
        return True


def basic_experiment(pop_size=15, sim_time=5.0, init_time=1.0, dt_frac=0.9,
                     seed=1):
    """(sim, env, pop) of examples/basic.py on the port: objectives
    NormFinalDist (max), age, voxel count and muscle count (min)."""
    random.seed(seed)
    np.random.seed(seed)
    sim = Sim(dt_frac=dt_frac, simulation_time=sim_time,
              fitness_eval_init_time=init_time)
    env = Env(sticky_floor=0, time_between_traces=0)
    objectives = ObjectiveDict()
    objectives.add_objective(name="fitness", maximize=True, tag="<NormFinalDist>")
    objectives.add_objective(name="age", maximize=False, tag=None)
    objectives.add_objective(name="num_voxels", maximize=False, tag=None,
                             node_func=np.count_nonzero,
                             output_node_name="material")
    objectives.add_objective(name="energy", maximize=False, tag=None,
                             node_func=partial(count_occurrences, keys=[3, 4]),
                             output_node_name="material")
    pop = Population(objectives, BasicGenotype, BasicPhenotype, pop_size=pop_size)
    return sim, env, pop


class RecordedEvaluation:
    """`evaluate_all` on one device that keeps a record per generation:
    evaluation seconds and their split (host prep, packing, launches), step
    buckets, K1 launches, the best NormFinalDist and every evaluated
    fitness. Picklable, so checkpoints can hold it."""

    def __init__(self, device):
        self.device = device
        self.records = []

    def __call__(self, sim, env, pop, *args, **kwargs):
        k1_before = fr.FUSED_ROLLOUT_LAUNCHES
        t0 = time.time()
        out = evaluation.evaluate_all(sim, env, pop, *args, device=self.device,
                                      **kwargs)
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()
        fits = [float(ind.fitness) for ind in pop]
        self.records.append(dict(
            gen=int(pop.gen), eval_s=time.time() - t0,
            buckets=list(evaluation.LAST_DISPATCH_TIMING.get("buckets", [])),
            **{k: evaluation.LAST_DISPATCH_TIMING.get(k, 0.0)
               for k in ("host_prep_s", "pack_s", "launch_s")},
            k1_launches=fr.FUSED_ROLLOUT_LAUNCHES - k1_before,
            best_norm_final_dist=max(fits), fitnesses=fits))
        return out


def evolution(gens=2, pop_size=15, device="cuda", directory=None, **experiment):
    """Run `gens` generations of the basic experiment on `device`; returns
    the per-generation records of `RecordedEvaluation`."""
    sim, env, pop = basic_experiment(pop_size=pop_size, **experiment)
    recorder = RecordedEvaluation(device)
    with tempfile.TemporaryDirectory() as tmp:
        opt = ParetoOptimization(sim, env, pop, evaluation_func=recorder)
        opt.run(max_hours_runtime=1, max_gens=gens - 1, num_random_individuals=1,
                directory=directory or os.path.join(tmp, "basic"), name="Basic",
                checkpoint_every=100, save_vxa_every=100)
    return recorder.records


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--coll-steps", type=int, default=20)
    ap.add_argument("--gens", type=int, default=2)
    ap.add_argument("--segments", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the port's benchmark needs a CUDA device")
    card = card_info()
    for kw in (dict(steps=args.steps), dict(steps=args.coll_steps, collision=True)):
        rec = throughput(batch=args.batch, **kw)
        print(json.dumps(dict(rec, card=card)), flush=True)
    for rec in evolution(gens=args.gens):
        rec.pop("fitnesses")
        print(json.dumps(dict(rec, card=card)), flush=True)
    for name, rec in mpc(segments=args.segments).items():
        print(json.dumps(dict(rec, workload="mpc " + name, card=card)), flush=True)
    print(json.dumps(dict(sqp(), workload="sqp fused", card=card)), flush=True)


if __name__ == "__main__":
    main()
