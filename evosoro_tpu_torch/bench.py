"""Benchmarks of the port on one card.

Four workloads, all from the JAX package's own benchmarks and examples:

- throughput: the root `bench.py` workload on the port: B concurrent 10³
  robots (`default_rng(0)`, material ids 1..4, random phase offsets) with
  thermal actuation, floor contact and gravity at `SimParams()` defaults,
  through one fused-rollout launch; reported as occupied voxel-steps per
  second;
- evolution: the `examples/basic.py` experiment (CPPN material tree, AFPO
  Pareto optimization of NormFinalDist vs age) at the `EVOBENCH.json`
  "basic" configuration: pop 15, 6³, 5 s of sim time, self-collision on;
  and, uncut, `examples/swimming_basic.py` (the same genome in water: 6³,
  5 s, drag coefficient 750, facet drag on the deformed mesh) and
  `examples/growth.py` (5×5×4 all-muscle bodies whose initial and final
  voxel sizes evolve: 10 s, dt_frac 0.5, growth amplitude 0.8);
- mpc: the `tools/bench_mpc.py` workload: one cold CEM solve over the 10³
  bench design (6 iterations x 128 candidates x 200 steps, 8 knots) through
  `cem_optimize_fused`, then a closed receding-horizon loop through
  `make_fused_mpc_closed_loop` (warm replans of 1 x 32 candidates, 4 of 8
  knots executed a segment);
- sqp: the gradient-MPC part of `tools/bench_mpc.py`: `FusedSQPSolver` on
  the same design without floor and gravity, 200 plan steps in 8 segments,
  8 knots, 4 Gauss-Newton iterations: one cold solve and re-plans from its
  result with moving targets, through K1 forward and the reverse-mode
  segment kernel B4 backward; and the same in water (the design in its
  one-cell shell, drag coefficient 750, with the facet or the voxel-face
  drag) and with growth (the growth experiment's 5×5×4 all-muscle design
  on its floor, with development fields whose ramps run within the
  horizon);
- replay: the four designs an evosoro run archived in
  `basic_data/bestSoFar/fitOnly/` (6³, collision on, 5 s), each read with
  `load_vxa` and replayed whole through `fused_rollout`, with the dense and
  with the surface-compacted contact pass (`EVOSORO_TPU_COLL_COMPACT=1`),
  as handing the file to Voxelyze does;
- materials: basic's experiment on a custom palette (`Env(materials=...)`:
  bilinear muscle that yields at 2 % strain, MDL_DATA fat of 5 points), and
  the throughput workload on that palette with plasticity and the
  max-velocity clamp on;
- volume: basic's experiment through a `Sim` whose `to_sim_params` turns on
  Voxelyze's VolumeEffectsEnabled (`VolumeSim`), the throughput workload
  with volume effects, and the replay of an archived design written back
  with the flag set.

Run:  python -m evosoro_tpu_torch.bench [--batch 1024] [--steps 200]
      [--gens 2] [--segments 4] [--experiments basic swimming growth materials]
      (needs a CUDA device; prints one JSON line per result)
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
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
from evosoro_tpu_torch.core.rollout import init_state, num_steps_for, relaunch_until_stop
from evosoro_tpu_torch.core.types import (
    DOF_ALL,
    DOF_Y,
    MDL_BILINEAR,
    MDL_DATA,
    EnvParams,
    Material,
    SimParams,
    evosoro_default_palette,
)
from evosoro_tpu_torch.evo import evaluation
from evosoro_tpu_torch.evo.algorithms import ParetoOptimization
from evosoro_tpu_torch.evo.base import Env, ObjectiveDict, Sim
from evosoro_tpu_torch.evo.networks import CPPN
from evosoro_tpu_torch.evo.softbot import Genotype, Phenotype, Population
from evosoro_tpu_torch.ops import fused_rollout as fr
from evosoro_tpu_torch.utils.functional import (
    count_negative,
    count_occurrences,
    count_positive,
)
from evosoro_tpu_torch.utils.phenotype_mappers import make_material_tree


def card_info() -> str:
    """`nvidia-smi`'s name and power limit of the cards, as it prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def bench_design(n=10, seed=0):
    """(structure, phase offsets) of the bench.py design: an n³ block of
    material ids 1..4 with random phase offsets, from `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    structure = rng.integers(1, 5, size=(n, n, n)).astype(np.int32)
    return structure, rng.uniform(-1, 1, size=(n, n, n))


def bench_body(n=10, seed=0, device="cpu"):
    """The bench.py design and its body on `device`."""
    structure, phase = bench_design(n, seed)
    palette = palette_from_list(evosoro_default_palette())
    body = build_body(structure, palette, phase_offset=phase, device=device)
    return structure, body


AGGREGATE_DRAG_COEF = 0.5 * 1.5 * 1000.0  # examples/swimming_basic.py


def materials_palette():
    """evosoro's 7-material palette with nonlinear materials in place of
    the linear ones, the material-model experiments `Env(materials=...)`
    runs: the muscles (3, 4) bilinear, yielding at 2 % strain to a tenth of
    their stiffness; the soft tissue (1) MDL_DATA, 5 points of a curve that
    softens with strain (initial modulus 5e6, the palette's fat)."""
    mats = evosoro_default_palette()
    for k in (2, 3):
        m = mats[k]
        mats[k] = Material(m.id, m.name, m.elastic_mod, cte=m.cte, rgba=m.rgba,
                           mat_model=MDL_BILINEAR, yield_stress=0.02 * m.elastic_mod,
                           plastic_mod=0.1 * m.elastic_mod)
    fat = mats[0]
    mats[0] = Material(fat.id, fat.name, cte=fat.cte, rgba=fat.rgba, mat_model=MDL_DATA,
                       ss_strain=(0.0, 0.01, 0.02, 0.05, 0.1),
                       ss_stress=(0.0, 5e4, 9e4, 1.6e5, 2.2e5))
    return mats


def bilinear_palette():
    """`materials_palette` with the soft tissue (1) left linear: the
    bilinear muscles (3, 4) alone, the palette the gradient-MPC benchmark
    runs on materials (both packages' reverse-mode kernels refuse
    MDL_DATA)."""
    mats = materials_palette()
    mats[0] = evosoro_default_palette()[0]
    return mats


def growth_fields(shape, dt, seed=0):
    """Random development fields for a body of `shape`, in units of the
    step `dt` so that a launch of 100 steps crosses every ramp: initial and
    final sizes in 0.6-1.4 L, growth starting within 50 steps and lasting
    10-100, final phase offsets and amplitude dampings."""
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, size=shape)

    return dict(initial_voxel_size=u(0.006, 0.014), final_voxel_size=u(0.006, 0.014),
                growth_time=u(10 * dt, 100 * dt), start_growth_time=u(0, 50 * dt),
                final_phase_offset=u(-1, 1), temp_amp_damp=u(0.5, 1.0),
                final_temp_amp_damp=u(0.2, 1.0))


def packed_workload(batch, n=10, collision=False, device="cuda", fluid=None,
                    devo=False, freeze=False, materials=False, equilibrium=False,
                    compact=False, volume=False):
    """Packed (state, body, stats, pair table) of `batch` copies of the
    bench design at rest, plus the launch's keyword arguments.

    `volume` turns on volume effects (the state carries the coupling carry,
    the stats row the dt of `calc_max_dt(volume_effects=True)`), with the
    thermal actuation of `EnvParams()` as the thermal stress's clock.

    `materials` puts the design on `materials_palette` with plasticity and
    the max-velocity clamp on (its MDL_DATA tables ride the keywords);
    `equilibrium` runs it in equilibrium mode; `compact` gives the contact
    pass the surface-compacted table.

    `fluid="face"` or `"mesh"` puts the design in water (drag coefficient
    750, actuation from time 0) with the voxel-face or the facet drag model,
    on a grid that carries the one-cell shell the mesh model needs, (n+1)³,
    for both, so the two models walk the same cells. `devo` gives
    the design random development fields (`growth_fields`) under a growth
    amplitude of 0.8, with IniCM time at 30 steps and, with `freeze`, a
    mid-life freeze of 20 steps around step 85. The variants keep the
    material, solver and volume options."""
    structure, phase = bench_design(n)
    palette = palette_from_list(materials_palette() if materials
                                else evosoro_default_palette())
    body = build_body(structure, palette, phase_offset=phase, device=device)
    # the options every variant keeps
    opts = dict(self_collisions_enabled=collision, plasticity_enabled=materials,
                max_velocity_enabled=materials, equilibrium_mode=equilibrium,
                volume_effects_enabled=volume)
    sim = SimParams(**opts)
    env = EnvParams()
    dt = calc_max_dt(body, volume) * sim.dt_frac
    if fluid is not None:
        if fluid not in ("face", "mesh"):
            raise ValueError(f"fluid must be 'face', 'mesh' or None, got {fluid!r}")
        sim = SimParams(**opts, init_cm_time=0.0)
        env = EnvParams(fluid_environment=True, gravity_enabled=False,
                        floor_enabled=False,
                        aggregate_drag_coefficient=AGGREGATE_DRAG_COEF)
        shell = ((0, 1), (0, 1), (0, 1))
        structure = np.pad(structure, shell)
        body = build_body(structure, palette, phase_offset=np.pad(phase, shell),
                          device=device)
        if fluid == "mesh":
            from evosoro_tpu_torch.envs.drag import attach_mesh_drag

            body = attach_mesh_drag(body)
    elif devo:
        step = float(dt)
        sim = SimParams(**opts, init_cm_time=30 * step,
                        stop_condition_value=200 * step, min_temp_fact=0.4,
                        mid_life_freeze_time=20 * step if freeze else 0.0)
        env = EnvParams(growth_amplitude=0.8)
        body = build_body(structure, palette, phase_offset=phase, device=device,
                          **growth_fields((n, n, n), step))
    grid = tuple(body.occ.shape)
    state = fr.pack_state_single(init_state(body, volume_effects=volume))
    state = state[None].expand(batch, -1, -1).contiguous()
    body_packed = fr.pack_body(body)
    stats = fr.make_stats(body, batch, dt, sim, env)
    table = None
    if collision:
        cs = build_collision_system(structure, body.e_mod.cpu().numpy(), 0.01)
        pack = fr.pack_collision_compact if compact else fr.pack_collision
        table = torch.as_tensor(pack(cs, grid), device=device)[None]
    kw = dict(grid_shape=grid,
              scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=fr.launch_flags(body, sim, env, collision=collision,
                                    collision_compact=collision and compact))
    if materials:
        kw["ss_packed"] = fr.pack_ss_tables(body).to(device)
    return (state, body_packed, stats, table), kw, int(body.occ.sum())


def big_body_design(n=12, seed=2):
    """(structure, phase offsets, the generator) of the JAX package's
    big-body fallback benchmark (tools/bench_fallback.py:156-215): an n³
    block of material ids 1..4 with 30 % of its cells empty and random phase
    offsets, from `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    structure = rng.integers(1, 5, size=(n, n, n)).astype(np.int32)
    structure[rng.random(structure.shape) < 0.3] = 0
    return structure, rng.uniform(-1, 1, size=structure.shape), rng


def big_body_workload(batch=32, n=12, collision=True, device="cuda", seed=2, fluid=False,
                      compact=False):
    """The launch of tools/bench_fallback.py's `big_collision_fallback` on
    the port: `batch` robots at rest on the `big_body_design` body (12³ with
    contact: 1728 cells, past one block's shared memory), robot 0 with the
    design's phase offsets and every other robot with its own (a body per
    robot, so no two robots compute the same bits), a pair table per robot
    with contact, `SimParams()` defaults. `fluid` puts the design in water
    with the facet drag, in its (n+1)³ corner shell, as the swimming
    experiment's evaluator does (drag coefficient 750, actuation from time
    0, no floor or gravity). `compact` gives the contact pass the
    surface-compacted table. Returns ((state, body, stats, pair table),
    launch keywords without num_steps, occupied voxels)."""
    structure, phase, rng = big_body_design(n, seed)
    phases = np.concatenate([phase[None], rng.uniform(-1, 1, size=(batch - 1,) + phase.shape)])
    palette = palette_from_list(evosoro_default_palette())
    sim = SimParams(self_collisions_enabled=collision)
    env = EnvParams()
    if fluid:
        shell = ((0, 1),) * 3
        structure = np.pad(structure, shell)
        phases = np.pad(phases, ((0, 0),) + shell)
        sim = SimParams(self_collisions_enabled=collision, init_cm_time=0.0)
        env = EnvParams(fluid_environment=True, gravity_enabled=False, floor_enabled=False,
                        aggregate_drag_coefficient=AGGREGATE_DRAG_COEF)
    body = build_body(structure, palette, phase_offset=phases[0], device=device)
    if fluid:
        from evosoro_tpu_torch.envs.drag import attach_mesh_drag

        body = attach_mesh_drag(body)
    grid = tuple(body.occ.shape)
    occ = torch.as_tensor(structure > 0, device=device).reshape(1, -1)
    body_packed = fr.pack_body(body).expand(batch, -1, -1).clone()
    body_packed[:, fr._B_PHASE] = torch.as_tensor(
        phases.reshape(batch, -1), dtype=torch.float32, device=device) * occ
    state = fr.pack_state_single(init_state(body))[None].expand(batch, -1, -1).contiguous()
    stats = fr.make_stats(body, batch, calc_max_dt(body) * sim.dt_frac, sim, env)
    table = None
    if collision:
        cs = build_collision_system(structure, body.e_mod.cpu().numpy(), 0.01)
        pack = fr.pack_collision_compact if compact else fr.pack_collision
        table = torch.as_tensor(pack(cs, grid), device=device)[None]
        table = table.expand(batch, -1, -1).contiguous()
    kw = dict(grid_shape=grid, scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=fr.launch_flags(body, sim, env, collision=collision,
                                    collision_compact=collision and compact))
    return (state, body_packed, stats, table), kw, int(occ.sum())


def volume_scenario_workload(batch=8, n=4, seed=0, device="cuda"):
    """The volume-effects design of the JAX package's on-chip parity run
    (tools/onchip_parity.py `_scenario_volume`): an n³ block of materials
    1..4 with random phase offsets (`bench_design`), actuation and the CoM
    capture from time 0 under a temperature amplitude of 10; `batch` robots
    at rest with the coupling carry, the first bond pass at the volume
    effects' rest dt. Returns (args, launch keywords without num_steps)."""
    structure, phase = bench_design(n, seed)
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=phase, device=device)
    sim = SimParams(volume_effects_enabled=True, init_cm_time=0.0)
    env = EnvParams(temp_amplitude=10.0)
    dt = calc_max_dt(body, True) * sim.dt_frac
    state = fr.pack_state_single(init_state(body, volume_effects=True))
    state = state[None].expand(batch, -1, -1).contiguous()
    kw = dict(grid_shape=tuple(body.occ.shape),
              scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=fr.launch_flags(body, sim, env, collision=False))
    return (state, fr.pack_body(body), fr.make_stats(body, batch, dt, sim, env), None), kw


def evaluator_workload(pop_size=15, collision=True, stagger=False, seed=1,
                       device="cuda", experiment="basic", drag_model="mesh"):
    """The packed (state, body, stats, pair table) that the evolution
    evaluator gives K1 for the first generation of an experiment (`basic`,
    `swimming` with `drag_model`, or `growth`): `pop_size` random designs,
    each with its own body, pair table and dt, padded up the batch ladder. Designs of one step bucket mostly share a
    dt, so `stagger` gives each robot its own dt (up to 25 % below its
    stable one) and moves its stop time and IniCM time to its own step
    within the first 100, so the freeze and the capture land on different
    steps per robot. Returns (args, launch keywords without num_steps)."""
    sim, env, pop = EXPERIMENTS[experiment](pop_size=pop_size, seed=seed)
    sim.self_collisions_enabled = collision
    env.drag_model = drag_model
    fn, inputs = evaluation.evaluator_batch(sim, env, list(pop), device=device)
    state, body, stats, table, ss = fn.pack(*inputs)
    if stagger:
        i = torch.arange(stats.shape[0], device=stats.device, dtype=stats.dtype)
        dt = stats[:, fr._S_DT] * (1.0 - i / (4 * stats.shape[0]))
        stats[:, fr._S_DT] = dt
        stats[:, fr._S_STOP] = dt * ((i * 37) % 97 + 3.5)
        stats[:, fr._S_INITCM] = dt * ((i * 53) % 89 + 0.5)
    kw = {k: v for k, v in fn.launch_kw.items() if k != "num_steps"}
    if ss is not None:
        kw["ss_packed"] = ss
    return (state, body, stats, table), kw


# the sources of the feature workloads, in lattice units of a 6^3 body: one
# swinging along x at 40 Hz, two fixed
FEATURE_SOURCES = (
    dict(pos=(0.05, 0.01, 0.01), amp=(0.02, 0.0, 0.0), freq=(40.0, 0.0, 0.0), enabled=True),
    dict(pos=(0.01, 0.08, 0.01), enabled=True),
    dict(pos=(0.0, 0.0, 0.1), enabled=True),
)


def with_features(kw, stats, n_win=4, n_src=3, freeze=True, **flags):
    """Launch keywords `kw` with the fitness features on: NormDistByVol
    (with the mid-life freeze's window), the fall-over latch, the needle,
    speed windows of `n_win` trace steps and the first `n_src` of
    FEATURE_SOURCES; `flags` override any. Times in steps of the batch's
    largest dt: a trace every 6 steps, the lifetime's end at step 100, a
    freeze window of 40 steps around step 60."""
    from evosoro_tpu_torch.envs.sources import make_sources

    step = float(stats[:, fr._S_DT].max())
    sources = make_sources(list(FEATURE_SOURCES[:n_src]))
    scalars = dict(kw["scalars"], tb=6 * step, sc_value=100 * step,
                   freeze=40 * step if freeze else 0.0, freeze_middle=60 * step,
                   sources=fr._source_statics(EnvParams(sources=sources)))
    fl = dict(kw["flags"], needle=True, falling=True, ndbv=True, window=n_win > 0,
              n_win=n_win, freeze_on=freeze)
    fl.update(flags)
    return dict(kw, scalars=scalars, flags=fl)


def feature_workload(n_win=4, n_src=3, collision=True, device="cuda", pop_size=15, **flags):
    """The evaluator's batch of the basic experiment (`evaluator_workload`:
    a body, pair table and dt per robot) made to exercise every fitness
    feature (`with_features`, with `flags` over it): a mat-7 needle in each
    design, and mat-6
    feet on the whole bottom layer of every other robot (those fall over
    once they actuate) and on one voxel of the rest. IniCM times at steps
    10-14; robots 1, 5, 9, ... stop at steps 153-195 (their end-of-life Y
    is captured then), the rest run on.
    Returns (args, launch keywords without num_steps)."""
    (state, body, stats, table), kw = evaluator_workload(
        pop_size=pop_size, collision=collision, device=device)
    B = state.shape[0]
    X, Y, Z = kw["grid_shape"]
    body = body.clone()
    occ = body[:, fr._B_OCC] > 0.5
    bottom = (torch.arange(X * Y * Z, device=body.device) % Z) == 0
    for b in range(B):
        cells = torch.nonzero(occ[b]).flatten()
        feet = cells[bottom[cells]] if b % 2 == 0 else cells[:1]
        body[b, fr._B_MAT, feet] = 6.0
        body[b, fr._B_MAT, cells[-1]] = 7.0
    stats = stats.clone()
    i = torch.arange(B, device=stats.device, dtype=stats.dtype)
    dt = stats[:, fr._S_DT]
    stats[:, fr._S_INITCM] = dt * (10 + i % 5)
    stats[:, fr._S_STOP] = torch.where(i % 4 == 1, dt * (150 + 3 * i), stats[:, fr._S_STOP])
    return (state, body, stats, table), with_features(kw, stats, n_win, n_src, **flags)


def ballistic_workload(device="cuda", pop_size=15, collision=True, trace_steps=8,
                       slowdown=1.0):
    """The growth experiment's evaluator batch (a body, pair table and dt
    per robot; contact on unless `collision` is false, as the ballistic
    experiment runs it) under speed windows of 4 trace steps with ballistic
    development: IniCM and the start of growth at step 10, a trace every
    `trace_steps` steps, and with `slowdown` 1 every decrease of the
    windowed speed halts development
    (threshold -0.5, as tests/test_devo_ballistic.py; with 0 the rebase
    keeps the final size). The state carries the development fields in
    channels 56-59 as `init_state(ballistic_devo=True)` packs them. Returns
    (args, launch keywords without num_steps)."""
    (state, body, stats, table), kw = evaluator_workload(
        pop_size=pop_size, collision=collision, device=device, experiment="growth")
    step = float(stats[:, fr._S_DT].max())
    stats = stats.clone()
    stats[:, fr._S_INITCM] = 10 * stats[:, fr._S_DT]
    body = body.clone()
    body[:, fr._B_START_GT] = torch.where(body[:, fr._B_OCC] > 0.5,
                                          10 * stats[:, fr._S_DT, None], 0.0)
    state = state.clone()
    for k, ch in enumerate((fr._B_INIT_SIZE, fr._B_FINAL_SIZE, fr._B_GROWTH_T, fr._B_START_GT)):
        state[:, fr._DEVO_DYN + k] = body[:, ch]
    scalars = dict(kw["scalars"], tb=trace_steps * step, min_growth_t=0.0, max_slow=-0.5,
                   bal_slow=slowdown)
    flags = dict(kw["flags"], window=True, n_win=4, ballistic=True)
    return (state, body, stats, table), dict(kw, scalars=scalars, flags=flags)


# ---------------------------------------------------------------------------
# Replaying .vxa files, as Voxelyze does with a file it is handed
# ---------------------------------------------------------------------------

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "basic_data", "bestSoFar", "fitOnly")


def fixture_paths():
    """The four designs an evosoro run archived beside the repository, the
    fitness the reference engine gave each in its file name."""
    return sorted(glob.glob(os.path.join(FIXTURE_DIR, "*.vxa")))


def replay_setup(path, device="cuda"):
    """(body, sim, env, dt, steps) of a .vxa file as Voxelyze runs it:
    `load_vxa`, the document's body with its collision tables when the file
    turns self-collision on, its dt and the steps of its stop time."""
    from evosoro_tpu_torch.io.vxa import load_vxa

    doc = load_vxa(path)
    body = doc.build_body(device=device)
    if doc.sim.self_collisions_enabled:
        body = body.replace(collision=build_collision_system(
            doc.structure, body.e_mod.cpu().numpy(), body.nominal_size,
            collision_horizon=float(doc.sim.collision_horizon)))
    dt = float(calc_max_dt(body, doc.sim.volume_effects_enabled)) * float(doc.sim.dt_frac)
    return body, doc.sim, doc.env, dt, num_steps_for(body, doc.sim, dt), doc


def _fitness_in_name(path):
    name = os.path.basename(path)
    return float(name.split("--fit_")[1].split("--")[0]) if "--fit_" in name else None


def replay(path, device="cuda", compact=False):
    """Replay one .vxa file whole through `fused_rollout` (one robot, the
    file's stop time) and `locomotion_fitness`; `compact` sets the
    surface-compacted contact switch for the launch. Under volume effects
    the step count is padded by 15 % (`num_steps_for`), and a replay that
    ends short of the stop time is made again longer, as the evaluator does
    (`relaunch_until_stop`; `short` is 1 if it still ends short). Returns a
    record: the fitness beside the one in the file's name (the reference
    engine's, for information), the steps and the launches' time on the
    host clock."""
    body, sim, env, dt, steps, doc = replay_setup(path, device)
    state = init_state(body, volume_effects=sim.volume_effects_enabled)
    state = state.replace(**{f.name: getattr(state, f.name)[None]
                             for f in dataclasses.fields(state)
                             if torch.is_tensor(getattr(state, f.name))})
    before = os.environ.get("EVOSORO_TPU_COLL_COMPACT")
    os.environ["EVOSORO_TPU_COLL_COMPACT"] = "1" if compact else "0"
    stop = float(sim.stop_condition_value)

    def run(n):
        return fr.fused_rollout(state, body, sim, env, n, dt, stop_time=stop,
                                stop_condition_type=doc.stop_condition_type)

    def short(result):
        outs = result[1]
        return (~outs.diverged & (outs.time < 0.999 * stop)).cpu().numpy()

    try:
        t0 = time.perf_counter()
        n_short = 0
        if sim.volume_effects_enabled:
            (new_state, outs), steps, relaunches, still_short = relaunch_until_stop(
                run, steps, short)
            n_short = int(still_short.sum())
        else:
            (new_state, outs), relaunches = run(steps), 0
        fit = fr.locomotion_fitness(new_state, body, outs)
        fit = float(fit[0])  # waits for the device
        secs = time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop("EVOSORO_TPU_COLL_COMPACT")
        else:
            os.environ["EVOSORO_TPU_COLL_COMPACT"] = before
    return dict(file=os.path.basename(path), compact=compact, steps=steps, dt=dt,
                bc=bool(doc.bcs), max_vel=bool(sim.max_velocity_enabled),
                volume=bool(sim.volume_effects_enabled), final_t=float(outs.time[0]),
                stop_time=stop, launches=relaunches + 1, short=n_short,
                dt_final=float(new_state.cur_dt[0]) if new_state.cur_dt is not None else dt,
                fitness=fit, fitness_in_name=_fitness_in_name(path),
                diverged=bool(outs.diverged[0]), seconds=secs,
                surface_voxels=int(np.asarray(body.collision.surf_mask).sum())
                if body.collision is not None else 0,
                voxels=int(body.occ.sum()), final_state=new_state)


def replay_workload(device="cuda"):
    """Every fixture (`fixture_paths`) replayed whole, once with the dense
    and once with the surface-compacted contact pass, then the hand-written
    cantilever (`write_cantilever_vxa`, into a temporary directory) with the
    max-velocity clamp and in equilibrium mode: a record each (`replay`)."""
    recs = [replay(p, device, compact) for p in fixture_paths()
            for compact in (False, True)]
    with tempfile.TemporaryDirectory() as tmp:
        for equilibrium in (False, True):
            path = write_cantilever_vxa(os.path.join(tmp, "cantilever.vxa"),
                                        max_vel=not equilibrium, equilibrium=equilibrium)
            recs.append(dict(replay(path, device), equilibrium=equilibrium))
    return recs


def replay_launch(path, batch=1, device="cuda", compact=False):
    """The packed K1 launch of a .vxa file's design (`replay_setup`),
    `batch` copies of its rest state, the pair table dense or
    surface-compacted: (args, launch keywords without num_steps)."""
    body, sim, env, dt, _, _ = replay_setup(path, device)
    grid = tuple(body.occ.shape)
    st = fr.pack_state_single(init_state(body, volume_effects=sim.volume_effects_enabled))
    st = st[None].expand(batch, -1, -1).contiguous()
    pack = fr.pack_collision_compact if compact else fr.pack_collision
    table = torch.as_tensor(pack(body.collision, grid), device=device)[None]
    stats = fr.make_stats(body, batch, dt, sim, env, float(sim.stop_condition_value))
    kw = dict(grid_shape=grid, scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=fr.launch_flags(body, sim, env, collision=True,
                                    collision_compact=compact))
    return (st, fr.pack_body(body), stats, table), kw


CANTILEVER_VXA = """<?xml version="1.0" encoding="ISO-8859-1"?>
<VXA Version="1.0">
<Simulator>
<Integration><DtFrac>0.9</DtFrac></Integration>
<Damping><BondDampingZ>1.0</BondDampingZ><ColDampingZ>0.8</ColDampingZ>
<SlowDampingZ>0.01</SlowDampingZ></Damping>
<Features><MaxVelLimitEnabled>{max_vel}</MaxVelLimitEnabled>
<MaxVoxVelLimit>0.01</MaxVoxVelLimit>
<VolumeEffectsEnabled>{volume}</VolumeEffectsEnabled></Features>
<StopCondition><StopConditionType>2</StopConditionType>
<StopConditionValue>0.5</StopConditionValue><InitCmTime>0.0</InitCmTime></StopCondition>
<EquilibriumMode><EquilibriumModeEnabled>{equilibrium}</EquilibriumModeEnabled>
</EquilibriumMode>
</Simulator>
<Environment>
<Boundary_Conditions>
<NumBCs>3</NumBCs>
<FRegion><PrimType>0</PrimType><X>0</X><Y>0</Y><Z>0</Z><dX>0</dX><dY>1</dY><dZ>1</dZ>
<DofFixed>{dof_all}</DofFixed></FRegion>
<FRegion><PrimType>0</PrimType><X>1</X><Y>0</Y><Z>0</Z><dX>0</dX><dY>1</dY><dZ>1</dZ>
<DofFixed>0</DofFixed><ForceX>0</ForceX><ForceY>0</ForceY><ForceZ>-2.0</ForceZ></FRegion>
<FRegion><PrimType>0</PrimType><X>0.5</X><Y>0</Y><Z>0</Z><dX>0</dX><dY>1</dY><dZ>1</dZ>
<DofFixed>{dof_y}</DofFixed><DisplaceY>0.002</DisplaceY></FRegion>
</Boundary_Conditions>
<Gravity><GravEnabled>1</GravEnabled><GravAcc>-9.81</GravAcc><FloorEnabled>0</FloorEnabled>
</Gravity>
<Thermal><TempEnabled>0</TempEnabled><VaryTempEnabled>0</VaryTempEnabled></Thermal>
</Environment>
<VXC Version="0.93">
<Lattice><Lattice_Dim>0.01</Lattice_Dim></Lattice>
<Palette>
<Material ID="1"><MatType>0</MatType><Name>Soft</Name>
<Mechanical><MatModel>0</MatModel><Elastic_Mod>5000000</Elastic_Mod><Density>1000000</Density>
<Poissons_Ratio>0.35</Poissons_Ratio><CTE>0</CTE><uStatic>1</uStatic><uDynamic>0.5</uDynamic>
</Mechanical></Material>
</Palette>
<Structure Compression="ASCII_READABLE">
<X_Voxels>{n}</X_Voxels><Y_Voxels>{n}</Y_Voxels><Z_Voxels>{n}</Z_Voxels>
<Data>
{layers}
</Data>
</Structure>
</VXC>
</VXA>
"""


def write_cantilever_vxa(path, n=10, max_vel=True, equilibrium=False, volume=False):
    """A hand-written .vxa of an n³ cantilever: a solid block, its x = 0
    face pinned in every degree of freedom, a region of 2 N in -z on its
    far face (split over the face's voxels) and a second region at
    mid-length whose y translation is held 2 mm from its nominal place;
    gravity on, no floor, no actuation, 0.5 s; the max-velocity clamp at
    0.01 lattice units a step, or equilibrium mode, which finds a
    structure's static deflection (and turns the clamp off); `volume` sets
    VolumeEffectsEnabled."""
    layer = "<Layer><![CDATA[" + "1" * (n * n) + "]]></Layer>"
    with open(path, "w") as f:
        f.write(CANTILEVER_VXA.format(dof_all=DOF_ALL, dof_y=DOF_Y, n=n, max_vel=int(max_vel),
                                      equilibrium=int(equilibrium), volume=int(volume),
                                      layers="\n".join([layer] * n)))
    return path


def write_volume_vxa(src, dst, stop_time=None):
    """The design of the .vxa file `src` (an archived fixture) written back
    to `dst` with `write_vxa`, as the file Voxelyze would be handed, with
    VolumeEffectsEnabled set (and the StopConditionValue `stop_time`, when
    given)."""
    from evosoro_tpu_torch.io.vxa import load_vxa, write_vxa

    doc = load_vxa(src)
    sim = doc.sim.replace(volume_effects_enabled=True)
    if stop_time is not None:
        sim = sim.replace(stop_condition_value=float(stop_time))
    write_vxa(dst, doc.structure, doc.materials, sim=sim, env=doc.env,
              voxel_arrays=doc.voxel_arrays, stop_condition_type=doc.stop_condition_type,
              lattice_dim=doc.lattice_dim)
    return dst


def volume_replay_workload(device="cuda"):
    """The first fixture written back with volume effects
    (`write_volume_vxa`) and the cantilever with them (`write_cantilever_vxa`
    without the clamp), each replayed whole (`replay`): a record each."""
    with tempfile.TemporaryDirectory() as tmp:
        fixture = write_volume_vxa(fixture_paths()[0], os.path.join(tmp, "fixture_volume.vxa"))
        cantilever = write_cantilever_vxa(os.path.join(tmp, "cantilever_volume.vxa"),
                                          max_vel=False, volume=True)
        return [replay(fixture, device), replay(cantilever, device)]


# the max-velocity clamp of the material workloads: 1e-3 lattice units a
# step (1e-5 m at 0.01 m), which an actuated 6^3 design reaches
MATERIALS_MAX_VEL = 1e-3


def materials_workload(pop_size=15, collision=True, device="cuda", seed=1):
    """The evaluator's batch of the materials experiment (a body, MDL_DATA
    tables, pair table and dt per robot: bilinear muscle, MDL_DATA tissue)
    with the two solver options a .vxa can switch on beside it: plasticity
    and the max-velocity clamp (`MATERIALS_MAX_VEL`); actuation starts at
    step 5, so a launch of tens of steps strains the muscles past their
    yield point and the tissue along its curve. Returns (args, launch
    keywords without num_steps)."""
    (state, body, stats, table), kw = evaluator_workload(
        pop_size=pop_size, collision=collision, device=device, experiment="materials",
        seed=seed)
    stats = stats.clone()
    stats[:, fr._S_INITCM] = 5 * stats[:, fr._S_DT]
    return (state, body, stats, table), dict(
        kw, flags=dict(kw["flags"], plasticity=True, max_vel=True),
        scalars=dict(kw["scalars"], max_vel_limit=MATERIALS_MAX_VEL))


def volume_workload(pop_size=15, collision=True, device="cuda", seed=1, features=False):
    """The evaluator's batch of the volume experiment (`volume_experiment`:
    a body, pair table, dt and coupling carry per robot) with actuation from
    step 5, so a launch of tens of steps is past its onset; with `features`
    every fitness feature (`with_features`, one source, the freeze window
    of 40 steps around step 60), which runs the volume instance's feature
    instance, and each robot's stop time on its own step within the first
    100 (as `evaluator_workload(stagger=True)`), so each robot freezes
    within the launch and its last step runs dry on its own recomputed dt.
    Returns (args, launch keywords without num_steps)."""
    (state, body, stats, table), kw = evaluator_workload(
        pop_size=pop_size, collision=collision, device=device, experiment="volume",
        seed=seed)
    stats = stats.clone()
    stats[:, fr._S_INITCM] = 5 * stats[:, fr._S_DT]
    if features:
        i = torch.arange(stats.shape[0], device=stats.device, dtype=stats.dtype)
        stats[:, fr._S_STOP] = stats[:, fr._S_DT] * ((i * 37) % 97 + 3.5)
        kw = with_features(kw, stats, n_win=4, n_src=1)
    return (state, body, stats, table), kw


def cantilever_workload(path, batch=2, n=10, device="cuda", volume=False):
    """The launch of the hand-written cantilever (`write_cantilever_vxa`
    at `path`, without the clamp, with volume effects when `volume`) read
    back with `load_vxa`: `batch` robots at rest, the BC channels in the
    keywords. Returns (args, launch keywords without num_steps, body)."""
    from evosoro_tpu_torch.io.vxa import load_vxa

    write_cantilever_vxa(path, n=n, max_vel=False, volume=volume)
    doc = load_vxa(path)
    body = doc.build_body(device=device)
    vol = doc.sim.volume_effects_enabled
    dt = float(calc_max_dt(body, vol)) * float(doc.sim.dt_frac)
    state = fr.pack_state_single(init_state(body, volume_effects=vol))[None].expand(
        batch, -1, -1).contiguous()
    stats = fr.make_stats(body, batch, dt, doc.sim, doc.env)
    kw = dict(grid_shape=tuple(body.occ.shape),
              scalars=fr.kernel_scalars(body.nominal_size, doc.sim, doc.env),
              flags=fr.launch_flags(body, doc.sim, doc.env, collision=False),
              bc_packed=fr.pack_bc_tables(body).to(device))
    return (state, fr.pack_body(body), stats, None), kw, body


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
               groups=4, reps=3, device="cuda", fluid=None, materials=False,
               compact=False, volume=False):
    """Voxel-steps per second of one fused-rollout call on the bench
    workload, beside the least time the card could take for it
    (`roofline.bound`); `plain` times K1's plain version on the same
    tensors. `fluid="mesh"` or `"face"` runs the design in water,
    `materials` on `materials_palette` with plasticity and the max-velocity
    clamp, `compact` with the surface-compacted contact pass, `volume` with
    volume effects (`packed_workload`)."""
    args, kw, n_occ = packed_workload(batch, collision=collision, device=device,
                                      fluid=fluid, materials=materials, compact=compact,
                                      volume=volume)
    call = fr.fused_rollout_plain if plain else fr.fused_call
    ms = time_call(lambda: call(*args, num_steps=steps, **kw), groups, reps)
    _, stats_out = call(*args, num_steps=steps, **kw)
    ss = kw.get("ss_packed")
    least = roofline.bound(*roofline.launch_work(
        *args, stats_out, flags=kw["flags"], grid_shape=kw["grid_shape"],
        n_pts=0 if ss is None else (ss.shape[1] - 3) // 2, num_steps=steps))
    return dict(batch=batch, steps=steps, collision=collision, fluid=fluid,
                materials=materials, compact=compact, volume=volume,
                grid=list(kw["grid_shape"]),
                impl="plain" if plain else "K1", ms=ms,
                voxel_steps_per_s=n_occ * batch * steps / (ms * 1e-3),
                bound_ms=least["bound_ms"], bound_by=least["bound_by"])


def eager_step_ms(steps=10, repeats=3, device="cpu", row_sum=None):
    """Milliseconds a step of the plain (eager) rollout takes on the
    evaluator batch (16 x 6^3, `evaluator_workload`) with contact on and
    off: the path the port's entry points run on the CPU. Wall clock, the
    best of `repeats` calls of `steps` steps each. `row_sum`, when given,
    replaces the dense pair pass's row sum (`fr.pair_contact_forces_plain`)
    for the contact run.

        python -c "from evosoro_tpu_torch import bench; print(bench.eager_step_ms())"
    """
    from unittest import mock

    out = dict(device=device, steps=steps, workload="evaluator batch 16 x 6^3")
    for coll in (True, False):
        args, kw = evaluator_workload(collision=coll, device=device)
        plain = fr.pair_contact_forces_plain
        pair = plain if row_sum is None else partial(plain, row_sum=row_sum)
        with mock.patch.object(fr, "pair_contact_forces_plain", pair):
            best = float("inf")
            for _ in range(repeats):
                if device != "cpu":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                fr.fused_rollout_plain(*args, num_steps=steps, **kw)
                if device != "cpu":
                    torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
        out["contact_ms" if coll else "no_contact_ms"] = 1e3 * best / steps
    return out


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


def sqp_workload(n=10, seed=0, device="cuda", fluid=None, devo=False, materials=False):
    """(body, sim, env, dt) of the fused-SQP benchmark: the bench design
    with actuation and the CoM capture from time 0 (`mpc_workload`) without
    floor and gravity; with `fluid="mesh"` or `"face"` the same design in
    water as `packed_workload(fluid=)` puts it (its one-cell +X/+Y/+Z shell,
    drag coefficient 750, with the facet or the voxel-face drag); with
    `devo` the growth experiment's 5×5×4 all-muscle design in its
    environment (floor and gravity, dt_frac 0.5, min_temp_fact 0.4, growth
    amplitude 0.8) with random development fields (`growth_fields`: growth
    starting within 50 steps and lasting 10-100, IniCM at step 30), so that
    its ramps run within a 200-step horizon; with `materials` the design on
    `bilinear_palette` with the max-velocity clamp at `MATERIALS_MAX_VEL`
    (the planner of a robot on a custom palette, `Env(materials=...)`, or of
    a .vxa file with MaxVelLimitEnabled), without floor and gravity, or in
    water or with growth as above, on that palette with the clamp."""
    palette = palette_from_list(bilinear_palette() if materials
                                else evosoro_default_palette())
    clamp = dict(max_velocity_enabled=True, max_vox_vel_limit=MATERIALS_MAX_VEL) \
        if materials else {}
    if devo:
        rng = np.random.default_rng(seed)
        structure = np.full(GROWTH_IND_SIZE, 3, np.int32)
        phase = rng.uniform(-1, 1, size=GROWTH_IND_SIZE)
        probe = build_body(structure, palette, phase_offset=phase, device=device)
        sim = SimParams(dt_frac=0.5, min_temp_fact=0.4)
        step = float(calc_max_dt(probe) * sim.dt_frac)
        sim = SimParams(dt_frac=0.5, min_temp_fact=0.4, init_cm_time=30 * step, **clamp)
        body = build_body(structure, palette, phase_offset=phase, device=device,
                          **growth_fields(GROWTH_IND_SIZE, step, seed))
        return body, sim, EnvParams(growth_amplitude=0.8), step
    if fluid is None and materials:
        structure, phase = bench_design(n, seed)
        body = build_body(structure, palette, phase_offset=phase, device=device)
        sim = SimParams(init_cm_time=0.0, **clamp)
        env = EnvParams(gravity_enabled=False, floor_enabled=False)
        return body, sim, env, float(calc_max_dt(body) * sim.dt_frac)
    if fluid is None:
        body, sim, _, dt = mpc_workload(n, seed, device)
        return body, sim, EnvParams(gravity_enabled=False, floor_enabled=False), dt
    if fluid not in ("face", "mesh"):
        raise ValueError(f"fluid must be 'face', 'mesh' or None, got {fluid!r}")
    structure, phase = bench_design(n, seed)
    shell = ((0, 1),) * 3
    body = build_body(np.pad(structure, shell), palette, phase_offset=np.pad(phase, shell),
                      device=device)
    if fluid == "mesh":
        from evosoro_tpu_torch.envs.drag import attach_mesh_drag

        body = attach_mesh_drag(body)
    sim = SimParams(init_cm_time=0.0, **clamp)
    env = EnvParams(fluid_environment=True, gravity_enabled=False, floor_enabled=False,
                    aggregate_drag_coefficient=AGGREGATE_DRAG_COEF)
    return body, sim, env, float(calc_max_dt(body) * sim.dt_frac)


def sqp(device="cuda", n=10, plan_steps=200, knots=8, n_res=8, num_iters=4,
        cg_iters=5, replans=3, seed=0, fluid=None, devo=False, materials=False):
    """The fused-SQP benchmark on `device`: one cold `FusedSQPSolver.solve`
    (target 0.4 lattice units of CoM-y travel) and `replans` warm re-plans
    from its result with targets `0.4 + 0.01 r`, on land without floor and
    gravity as in `tools/bench_mpc.py`, in water (`fluid`), with growth
    (`devo`, on the growth experiment's floor) or on the bilinear palette
    with the max-velocity clamp (`materials`): `sqp_workload`. Returns the
    cold solve's cost traces and launch counts, and milliseconds per
    re-plan."""
    body, sim, env, dt = sqp_workload(n, seed, device, fluid=fluid, devo=devo,
                                      materials=materials)
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
        n=n, grid=list(body.occ.shape), fluid=fluid, devo=devo, materials=materials,
        plan_steps=plan_steps, knots=knots, n_res=n_res,
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
# The experiments of examples/: basic.py, swimming_basic.py, growth.py
# ---------------------------------------------------------------------------

BASIC_IND_SIZE = (6, 6, 6)  # examples/basic.py IND_SIZE


class BasicGenotype(Genotype):
    """One CPPN whose four outputs form the material decision tree
    (examples/basic.py MyGenotype), on a grid of `size` (examples/basic.py:
    6³)."""

    def __init__(self, size=BASIC_IND_SIZE):
        super().__init__(orig_size_xyz=tuple(size))
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
                     seed=1, size=BASIC_IND_SIZE):
    """(sim, env, pop) of examples/basic.py on the port: objectives
    NormFinalDist (max), age, voxel count and muscle count (min); `size`,
    the genome's grid (12³: bodies past one block's shared memory, which K1
    runs in its device-memory instances)."""
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
    pop = Population(objectives, partial(BasicGenotype, size), BasicPhenotype,
                     pop_size=pop_size)
    return sim, env, pop


def swimming_experiment(pop_size=15, sim_time=5.0, init_time=1.0, dt_frac=0.9,
                        seed=1, drag_model="mesh"):
    """(sim, env, pop) of examples/swimming_basic.py on the port: the basic
    genome and validity rule in a fluid environment (no gravity, no floor,
    aggregate drag coefficient 0.5·1.5·1000), fitness
    normAbsoluteDisplacement. `drag_model`: "mesh" (facet drag on the
    deformed surface mesh, the default) or "voxel_face"."""
    random.seed(seed)
    np.random.seed(seed)
    sim = Sim(dt_frac=dt_frac, simulation_time=sim_time,
              fitness_eval_init_time=init_time)
    env = Env(sticky_floor=0, time_between_traces=0, drag_model=drag_model)
    env.add_param("fluid_environment", 1, "<FluidEnvironment>")
    env.add_param("aggregate_drag_coefficient", AGGREGATE_DRAG_COEF,
                  "<AggregateDragCoefficient>")
    objectives = ObjectiveDict()
    objectives.add_objective(name="fitness", maximize=True,
                             tag="<normAbsoluteDisplacement>")
    objectives.add_objective(name="age", maximize=False, tag=None)
    objectives.add_objective(name="num_voxels", maximize=False, tag=None,
                             node_func=np.count_nonzero,
                             output_node_name="material")
    objectives.add_objective(name="energy", maximize=False, tag=None,
                             node_func=partial(count_occurrences, keys=[3, 4]),
                             output_node_name="material")
    pop = Population(objectives, BasicGenotype, BasicPhenotype, pop_size=pop_size)
    return sim, env, pop


GROWTH_IND_SIZE = (5, 5, 4)  # examples/growth.py IND_SIZE


class GrowthGenotype(Genotype):
    """Two CPPNs: per-voxel <InitialVoxelSize> and <FinalVoxelSize>
    (examples/growth.py MyGenotype)."""

    def __init__(self):
        super().__init__(orig_size_xyz=GROWTH_IND_SIZE)
        stats = [np.median, np.mean, np.std, count_negative, count_positive]
        self.add_network(CPPN(output_node_names=["initial_size"]))
        self.to_phenotype_mapping.add_map(
            name="initial_size", tag="<InitialVoxelSize>", logging_stats=stats)
        self.add_network(CPPN(output_node_names=["final_size"]))
        self.to_phenotype_mapping.add_map(
            name="final_size", tag="<FinalVoxelSize>", logging_stats=stats)


def growth_experiment(pop_size=15, sim_time=10.0, init_time=0.5, dt_frac=0.5,
                      seed=1):
    """(sim, env, pop) of examples/growth.py on the port: a fixed all-muscle
    5×5×4 body whose per-voxel initial and final sizes are CPPN outputs,
    min_temp_fact 0.4, growth amplitude 0.8, fitness NormFinalDist."""
    random.seed(seed)
    np.random.seed(seed)
    sim = Sim(dt_frac=dt_frac, simulation_time=sim_time, min_temp_fact=0.4,
              fitness_eval_init_time=init_time)
    env = Env()
    env.add_param("growth_amplitude", 0.8, "<GrowthAmplitude>")
    objectives = ObjectiveDict()
    objectives.add_objective(name="fitness", maximize=True, tag="<NormFinalDist>")
    objectives.add_objective(name="age", maximize=False, tag=None)
    pop = Population(objectives, GrowthGenotype, Phenotype, pop_size=pop_size)
    return sim, env, pop


# the oscillating light source of the features experiment: 20 lattice
# units ahead of the 6^3 body in +X, swinging 5 units in y at 0.5 Hz
FEATURE_SOURCE = dict(pos=(0.2, 0.03, 0.03), amp=(0.0, 0.05, 0.0), freq=(0.0, 0.5, 0.0),
                      enabled=True)


def features_experiment(pop_size=15, sim_time=5.0, init_time=1.0, dt_frac=0.9,
                        seed=1):
    """(sim, env, pop) of examples/basic.py with the fitness features the
    reference's Env carries switched on: NormDistByVol, the fall-over latch,
    speed windows of 4 trace steps (a trace every 0.01 s) and one oscillating
    light source (FEATURE_SOURCE); fitness NormFinalDist, which NormDistByVol
    turns into the volume-normalized trace sum."""
    from evosoro_tpu_torch.envs.sources import make_sources

    sim, env, pop = basic_experiment(pop_size=pop_size, sim_time=sim_time,
                                     init_time=init_time, dt_frac=dt_frac, seed=seed)
    env.add_param("norm_dist_by_vol", 1, "<NormDistByVol>")
    env.add_param("falling_prohibited", 1, "<FallingProhibited>")
    env.add_param("num_trace_steps_in_window", 4, "<NumTraceStepsInWindow>")
    env.sources = make_sources([FEATURE_SOURCE])
    return sim, env, pop


def ballistic_experiment(pop_size=15, sim_time=10.0, init_time=0.5, dt_frac=0.5,
                         seed=1):
    """(sim, env, pop) of examples/growth.py with speed windows of 4 trace
    steps (a trace every 0.01 s): the evolved final sizes then develop
    ballistically, rebased every step from the windowed speeds."""
    sim, env, pop = growth_experiment(pop_size=pop_size, sim_time=sim_time,
                                      init_time=init_time, dt_frac=dt_frac, seed=seed)
    env.add_param("num_trace_steps_in_window", 4, "<NumTraceStepsInWindow>")
    return sim, env, pop


def materials_experiment(pop_size=15, sim_time=5.0, init_time=1.0, dt_frac=0.9,
                         seed=1):
    """(sim, env, pop) of examples/basic.py on a custom palette, evosoro's
    hook for material-model experiments (`Env(materials=...)`): the
    muscles bilinear, yielding at 2 % strain, the soft tissue MDL_DATA of 5
    points (`materials_palette`); fitness NormFinalDist."""
    sim, env, pop = basic_experiment(pop_size=pop_size, sim_time=sim_time,
                                     init_time=init_time, dt_frac=dt_frac, seed=seed)
    env.materials = materials_palette()
    return sim, env, pop


def swimming_materials_experiment(pop_size=15, sim_time=5.0, init_time=1.0, dt_frac=0.9,
                                  seed=1, drag_model="mesh"):
    """(sim, env, pop) of examples/swimming_basic.py on `materials_palette`
    (`Env(materials=...)`), the swimming counterpart of
    `materials_experiment`: bilinear muscles and MDL_DATA soft tissue in a
    fluid, through K1's material instance of the drag model's variant;
    fitness normAbsoluteDisplacement."""
    sim, env, pop = swimming_experiment(pop_size=pop_size, sim_time=sim_time,
                                        init_time=init_time, dt_frac=dt_frac, seed=seed,
                                        drag_model=drag_model)
    env.materials = materials_palette()
    return sim, env, pop


class VolumeSim(Sim):
    """A `Sim` whose SimParams turn on Voxelyze's VolumeEffectsEnabled: the
    stock `to_sim_params` sets no volume flag, in either package, so a
    caller reaches volume effects in the evolution loop this way."""

    def to_sim_params(self) -> SimParams:
        return super().to_sim_params().replace(volume_effects_enabled=True)


def volume_experiment(pop_size=15, sim_time=5.0, init_time=1.0, dt_frac=0.9, seed=1):
    """(sim, env, pop) of examples/basic.py with volume effects on
    (`VolumeSim`): the Poisson-coupled bond stress with the thermal term of
    the actuation's temperature, a dt recomputed every step; fitness
    NormFinalDist."""
    _, env, pop = basic_experiment(pop_size=pop_size, sim_time=sim_time,
                                   init_time=init_time, dt_frac=dt_frac, seed=seed)
    sim = VolumeSim(dt_frac=dt_frac, simulation_time=sim_time,
                    fitness_eval_init_time=init_time)
    return sim, env, pop


EXPERIMENTS = dict(basic=basic_experiment, swimming=swimming_experiment,
                   growth=growth_experiment, features=features_experiment,
                   ballistic=ballistic_experiment, materials=materials_experiment,
                   volume=volume_experiment,
                   swimming_materials=swimming_materials_experiment)


class RecordedEvaluation:
    """`evaluate_all` on one device that keeps a record per generation:
    evaluation seconds and their split (host prep, packing, launches), step
    buckets, K1 launches, the launches made again under volume effects and
    the robots still short of their stop time after the last (their count,
    final times and fitness), the best NormFinalDist and every evaluated
    fitness. Picklable, so checkpoints can hold it."""

    def __init__(self, device):
        self.device = device
        self.records = []

    def __call__(self, sim, env, pop, *args, **kwargs):
        k1_before = fr.FUSED_ROLLOUT_LAUNCHES
        fluid_before = fr.FUSED_ROLLOUT_FLUID_LAUNCHES
        devo_before = fr.FUSED_ROLLOUT_DEVO_LAUNCHES
        feature_before = fr.FUSED_ROLLOUT_FEATURE_LAUNCHES
        ballistic_before = fr.FUSED_ROLLOUT_BALLISTIC_LAUNCHES
        material_before = fr.FUSED_ROLLOUT_MATERIAL_LAUNCHES
        volume_before = fr.FUSED_ROLLOUT_VOLUME_LAUNCHES
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
            k1_fluid_launches=fr.FUSED_ROLLOUT_FLUID_LAUNCHES - fluid_before,
            k1_devo_launches=fr.FUSED_ROLLOUT_DEVO_LAUNCHES - devo_before,
            k1_feature_launches=fr.FUSED_ROLLOUT_FEATURE_LAUNCHES - feature_before,
            k1_ballistic_launches=fr.FUSED_ROLLOUT_BALLISTIC_LAUNCHES - ballistic_before,
            k1_material_launches=fr.FUSED_ROLLOUT_MATERIAL_LAUNCHES - material_before,
            k1_volume_launches=fr.FUSED_ROLLOUT_VOLUME_LAUNCHES - volume_before,
            redispatches=evaluation.LAST_DISPATCH_TIMING.get("redispatches", 0),
            short_after_redispatch=evaluation.LAST_DISPATCH_TIMING.get(
                "short_after_redispatch", 0),
            short_final_times=list(evaluation.LAST_DISPATCH_TIMING.get(
                "short_final_times", [])),
            short_fitnesses=[float(ind.fitness) for ind in pop
                             if ind.id in evaluation.LAST_DISPATCH_TIMING.get(
                                 "short_ids", ())],
            best_norm_final_dist=max(fits), fitnesses=fits))
        return out


def evolution(gens=2, pop_size=15, device="cuda", directory=None,
              experiment="basic", **settings):
    """Run `gens` generations of an experiment (a name of EXPERIMENTS:
    `basic`, `swimming`, `growth`, `features`, `ballistic`, `materials` or
    `volume`;
    `settings` go to its constructor) on `device`; returns the
    per-generation records of `RecordedEvaluation`."""
    sim, env, pop = EXPERIMENTS[experiment](pop_size=pop_size, **settings)
    recorder = RecordedEvaluation(device)
    with tempfile.TemporaryDirectory() as tmp:
        opt = ParetoOptimization(sim, env, pop, evaluation_func=recorder)
        opt.run(max_hours_runtime=1, max_gens=gens - 1, num_random_individuals=1,
                directory=directory or os.path.join(tmp, experiment),
                name=experiment.capitalize(), checkpoint_every=100,
                save_vxa_every=100)
    return recorder.records


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--coll-steps", type=int, default=20)
    ap.add_argument("--gens", type=int, default=2)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--experiments", nargs="*", default=list(EXPERIMENTS),
                    choices=list(EXPERIMENTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the port's benchmark needs a CUDA device")
    card = card_info()
    for kw in (dict(steps=args.steps), dict(steps=args.coll_steps, collision=True),
               dict(steps=args.steps, fluid="mesh"), dict(steps=args.steps, fluid="face"),
               dict(steps=args.steps, materials=True), dict(steps=args.steps, volume=True)):
        rec = throughput(batch=args.batch, **kw)
        print(json.dumps(dict(rec, card=card)), flush=True)
    for rec in replay_workload() + volume_replay_workload():
        rec.pop("final_state")
        print(json.dumps(dict(rec, workload="replay", card=card)), flush=True)
    for name in args.experiments:
        for rec in evolution(gens=args.gens, experiment=name):
            rec.pop("fitnesses")
            print(json.dumps(dict(rec, experiment=name, card=card)), flush=True)
    for name, rec in mpc(segments=args.segments).items():
        print(json.dumps(dict(rec, workload="mpc " + name, card=card)), flush=True)
    print(json.dumps(dict(sqp(), workload="sqp fused", card=card)), flush=True)


if __name__ == "__main__":
    main()
