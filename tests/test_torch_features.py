"""The port's fitness features held against the JAX package on the same
inputs, made with numpy from a seed: NormDistByVol (whole life, afterlife
regime, mid-life frozen window), the fall-over latch, the needle, the
end-of-life posterior Y, speed windows and ballistic development
(VX_SimGA.cpp:25-203, VX_Sim.cpp:1064-1107, 1412-1419, 1600-1606).

- Eager `rollout` against JAX's in float64, every feature at once, at the
  tolerances of tests/test_torch_rollout.py (distances in lattice units rtol
  1e-5 / atol 1e-8, counts and flags equal): the two step the same physics
  and differ only where the quaternion snap flips on the last bit.
- `fused_rollout` on CPU tensors (the plain version of K1's feature
  instance) against the JAX Pallas kernel in interpret mode, float32, over
  40 steps with a trace every 2.5 steps (12 traces, 3 windows of 4): counters
  and latches equal; the feature sums at rtol 5e-3 (atol 1e-6 lattice
  units), as the port's earlier files hold metrics past the actuation onset
  (XLA contracts FMA, eager torch does not); ballistic development's
  rebased fields at rtol 2e-4, as tests/test_fused_features.py holds the
  JAX kernel against its eager path. Every feature rides one launch: each
  compile of the JAX kernel in interpret mode costs some 20 s.
- The evaluator's needle / fall-over wiring (`make_fused_evaluator` ->
  kernel flags -> `packed_metrics`) against the eager rollout, as
  tests/test_fused_features.py holds the JAX package's two evaluators.
- `supports()`, `packed_metrics` and `stats_to_outputs` against JAX's.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_outputs import stored

from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.core.rollout import rollout as j_rollout
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu.envs.sources import make_sources as j_make_sources
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.core import (
    EnvParams,
    SimParams,
    build_body,
    calc_max_dt,
    evosoro_default_palette,
    init_state,
    palette_from_list,
    rollout,
)
from evosoro_tpu_torch.core.rollout import _expand_state
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)
jfr = importlib.import_module("evosoro_tpu.ops.fused_rollout")

L = 0.01
DIST = dict(rtol=1e-5, atol=1e-8)  # lattice units, float64
METRIC = dict(rtol=5e-3, atol=1e-6)  # lattice units, float32 past the onset


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _walker(extra=None, dtype=jnp.float64, **devo):
    """tests/test_fused_features.py's 3x3x2 walker: muscle below, tissue
    above, with `extra` voxels {(i, j, k): material}."""
    rng = np.random.default_rng(7)
    s = np.zeros((3, 3, 2), dtype=np.int32)
    s[:, :, 0] = 3
    s[:, :, 1] = 1
    for (i, j, k), m in (extra or {}).items():
        s[i, j, k] = m
    phase = rng.uniform(-1, 1, size=s.shape) * (s > 0)
    return j_build_body(s, j_palette(j_default_palette()), lattice_dim=L,
                        phase_offset=phase, dtype=dtype, **devo)


def _port(jb, dtype=torch.float64):
    return convert.body_from_numpy(_np(jb), dtype=dtype)


GROW = dict(initial_voxel_size=np.full((3, 3, 2), L), final_voxel_size=np.full((3, 3, 2), 1.4 * L),
            growth_time=np.full((3, 3, 2), 0.15), start_growth_time=np.zeros((3, 3, 2)))


def _sources():
    return j_make_sources([
        dict(pos=(0.05, 0.01, 0.01), amp=(0.02, 0, 0), freq=(40.0, 0, 0), enabled=True),
        dict(pos=(0.01, 0.08, 0.01), enabled=True),
        dict(pos=(0.5, 0.5, 0.5), enabled=False)])


def test_rollout_features_match_jax():
    """Every feature on at once, eager, float64, on a growing walker: a
    foot and a needle in the design, NormDistByVol with an afterlife and a
    mid-life freeze, windows of 5 trace samples (a trace every 2 steps, so
    ballistic development rebases from step 23 on), the fall-over latch and
    two sources (one swinging; the eager path tracks disabled ones too, as
    JAX's does); 30 steps cross the IniCM capture, the freeze window, the
    end of life and part of the afterlife."""
    jb = _walker({(0, 0, 0): 6, (1, 1, 1): 7}, **GROW)
    dt = float(j_calc_max_dt(jb)) * 0.9
    sim = JSim(stop_condition_value=16 * dt, init_cm_time=3 * dt, afterlife_time=8 * dt,
               mid_life_freeze_time=10 * dt)
    env = JEnv(norm_dist_by_vol=True, falling_prohibited=True, needle_in_haystack=True,
               num_trace_steps_in_window=5, time_between_traces=2 * dt,
               temp_amplitude=5.0, growth_amplitude=0.5, sources=_sources(),
               ballistic_slowdown_fact=1.0, max_slowdown_permitted=-0.5)
    ref = jax.jit(lambda: j_rollout(jb, sim, env, num_steps=30, dt=dt, trace_every=2))()
    body = _port(jb)
    got = rollout(body, convert.sim_params_from_jax(sim),
                  convert.env_params_from_jax(env), 30, dt=dt, trace_every=2)
    for f in ("norm_final_dist", "final_dist", "norm_regime_dist", "norm_frozen_dist",
              "end_of_life_posterior_y", "fall_adj_post_y", "push_dist",
              "norm_window_dist", "posterior_dist", "source_min_dist",
              "source_avg_min_dist"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   err_msg=f, **DIST)
    for f in ("fell_over", "found_needle", "num_touching_floor",
              "num_non_feet_touching_floor", "diverged"):
        assert int(getattr(got, f)) == int(getattr(ref, f)), f
    assert int(got.found_needle) == 1 and float(got.norm_frozen_dist) != 0.0
    assert float(got.norm_regime_dist) != float(got.posterior_dist - got.end_of_life_posterior_y)
    np.testing.assert_allclose(got.vol_trace.numpy(), np.asarray(ref.vol_trace), rtol=1e-12)
    # tests/test_fitness_and_shape.py's invariants: the volume trace counts
    # voxels ((scale/L)^3) at rest, extremes and touch counts in order
    n_occ = int(np.asarray(jb.occ).sum())
    assert abs(float(got.vol_trace[0]) - n_occ) < 1e-9 * n_occ
    assert float(got.anterior_dist) >= float(got.posterior_dist)
    assert float(got.anterior_y) >= float(got.posterior_y)
    assert 0 <= int(got.num_non_feet_touching_floor) <= int(got.num_touching_floor) <= n_occ
    # ballistic development: the windows and the rebased per-voxel fields
    jd, pd = ref.final_state.devo, got.final_state.devo
    assert int(pd.win_count) == int(jd.win_count) >= 2
    for f in ("win_last", "win_prev"):
        np.testing.assert_allclose(float(getattr(pd, f)), float(getattr(jd, f)), **DIST)
    for f in ("initial_voxel_size", "final_voxel_size", "growth_time", "start_growth_time"):
        np.testing.assert_allclose(getattr(pd, f).numpy(), np.asarray(getattr(jd, f)),
                                   rtol=1e-7, atol=1e-12, err_msg=f)
    occ = body.occ.numpy()
    assert (pd.start_growth_time.numpy()[occ] > 0).all()  # rebased onto a sim time
    np.testing.assert_allclose(got.final_state.scale.numpy(), np.asarray(ref.final_state.scale),
                               rtol=1e-9)


def test_fall_over_zeroes_fitness():
    """A body of mat-6 feet trips the latch at once (reference:
    VX_SimGA.cpp:115-126): zero normalized distances, the workspace height
    off FallAdjPostY, and the state frozen from the step it fell."""
    s = np.full((3, 3, 2), 6, dtype=np.int32)
    body = build_body(s, palette_from_list(evosoro_default_palette()),
                      phase_offset=np.zeros(s.shape), dtype=torch.float64)
    dt = float(calc_max_dt(body)) * 0.9
    sim = SimParams(stop_condition_value=5 * dt, init_cm_time=dt)
    res = rollout(body, sim, EnvParams(falling_prohibited=True), 8, dt=dt)
    assert bool(res.fell_over)
    assert float(res.norm_final_dist) == 0.0 and float(res.norm_regime_dist) == 0.0
    assert float(res.fall_adj_post_y) == float(res.end_of_life_posterior_y) - 2
    assert float(res.final_state.time) < 3 * dt  # frozen, not run to the end


def test_needle_untouched_reports_zero():
    """No mat-7 voxel: the needle is the masked mean's zero both times."""
    jb = _walker()
    body = _port(jb)
    dt = float(calc_max_dt(body)) * 0.9
    res = rollout(body, SimParams(stop_condition_value=0.02, init_cm_time=0.0),
                  EnvParams(needle_in_haystack=True, temp_enabled=False), 10, dt=dt)
    assert int(res.found_needle) == 0 and float(res.push_dist) == 0.0


FEATURES_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                                "features_kernel_jax.npz")
FEATURE_FIELDS = ("fell_over", "win_count", "cm_captured", "norm_dist_by_vol",
                  "norm_frozen_dist_by_vol", "norm_window_dist", "win_prev_dist",
                  "end_of_life_posterior_y", "source_min_dist", "source_avg_min_dist",
                  "ini_needle")


def features_kernel_case():
    """The JAX inputs of `test_fused_features_match_jax_kernel`: (body, sim,
    env, dt, a batch of 8 at rest with its ballistic-development carry)."""
    jb = _walker({(0, 0, 0): 6, (1, 1, 1): 7}, dtype=jnp.float32, **GROW)
    dt = float(j_calc_max_dt(jb)) * 0.9
    sim = JSim(init_cm_time=3 * dt, stop_condition_value=30 * dt,
               mid_life_freeze_time=10 * dt)
    env = JEnv(needle_in_haystack=True, falling_prohibited=True, norm_dist_by_vol=True,
               num_trace_steps_in_window=4, time_between_traces=2.5 * dt, sources=_sources(),
               growth_amplitude=0.5, ballistic_slowdown_fact=1.0, max_slowdown_permitted=-0.5)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (8,) + x.shape),
                                     j_init_state(jb, ballistic_devo=True))
    return jb, sim, env, dt, batched


def features_kernel_jax() -> tuple:
    """(inputs, outputs) of the JAX kernel in interpret mode, 40 steps."""
    jb, sim, env, dt, batched = case = features_kernel_case()
    j_out, js = jfr.fused_rollout(batched, jb, sim, env, num_steps=40, dt=dt,
                                  interpret=True, stop_time=float(sim.stop_condition_value))
    return case, dict({f: getattr(js, f) for f in FEATURE_FIELDS}, pos=j_out.pos,
                      final_voxel_size=j_out.devo.final_voxel_size,
                      start_growth_time=j_out.devo.start_growth_time)


def test_fused_features_match_jax_kernel():
    """Every feature at once through the fused rollout, on a growing walker:
    needle, fall-over latch (one foot: it cannot trip), NormDistByVol with
    the frozen window, windows of 4 with ballistic development (every
    decrease of the windowed speed halts development), two sources (one
    swinging, a third disabled), 40 steps with a trace every 2.5 steps and
    the stop time at step 30, so the frozen tail's sample is taken too. The
    port's plain version against the JAX kernel in interpret mode on the
    same batch of 8 robots (float32), read from
    `tests/fixtures/features_kernel_jax.npz` (`make_features_kernel_jax.py`:
    its compile was most of this test's time) after checking that it ran on
    these inputs."""
    case = features_kernel_case()
    jb, sim, env, dt, _ = case
    js = stored(FEATURES_FIXTURE, "kernel", *case)
    assert jfr.supports(jb, sim, env)
    body = _port(jb, torch.float32)
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)
    assert fr.supports(body, psim, penv)
    pst = _expand_state(init_state(body, ballistic_devo=True), (8,), ())
    out, ps = fr.fused_rollout(pst, body, psim, penv, num_steps=40, dt=dt,
                               stop_time=float(sim.stop_condition_value))
    for f in ("fell_over", "win_count", "cm_captured"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(), js[f], err_msg=f)
    for f in ("norm_dist_by_vol", "norm_frozen_dist_by_vol", "norm_window_dist",
              "win_prev_dist", "end_of_life_posterior_y", "source_min_dist",
              "source_avg_min_dist"):
        np.testing.assert_allclose(getattr(ps, f).numpy(), js[f], err_msg=f, **METRIC)
    np.testing.assert_allclose(ps.ini_needle.numpy(), js["ini_needle"], rtol=1e-6, atol=1e-9)
    assert int(ps.win_count[0]) >= 3 and float(ps.norm_frozen_dist_by_vol[0]) != 0.0
    assert ps.source_min_dist.shape == (8, 2)  # the disabled source is not tracked
    # the rebased development fields ride the state
    occ = np.asarray(jb.occ)
    for f in ("final_voxel_size", "start_growth_time"):
        np.testing.assert_allclose(getattr(out.devo, f)[0].numpy()[occ], js[f][0][occ],
                                   rtol=2e-4, atol=1e-9, err_msg=f)
    assert (out.devo.start_growth_time[0].numpy()[occ] > 0).all()
    assert int(out.devo.win_count[0]) == int(ps.win_count[0])
    np.testing.assert_allclose(out.pos.numpy(), js["pos"], rtol=5e-5, atol=1e-7)


def test_falling_latch_parity():
    """tests/test_fused_features.py's top-heavy walker with a bottom layer
    of mat-6 feet, which falls over. The eager rollout's latch against
    JAX's in float64: the same step trips it, the state freezes there, and
    FallAdjPostY is the end-of-life Y less the workspace height. The fused
    path's latch and frozen state (float32) against the eager rollout's
    (which also ends the sim on the latch)."""
    sim, env = SimParams(init_cm_time=0.001, stop_condition_value=1.0), \
        EnvParams(falling_prohibited=True)
    feet = {(i, j, 0): 6 for i in range(3) for j in range(3)}
    jb = _walker(feet)
    dt = float(j_calc_max_dt(jb)) * float(sim.dt_frac)
    ref = jax.jit(lambda: j_rollout(jb, JSim(init_cm_time=0.001, stop_condition_value=1.0),
                                    JEnv(falling_prohibited=True), num_steps=40, dt=dt,
                                    stop_time=1.0))()
    res = rollout(_port(jb), sim, env, 40, dt=dt, stop_time=1.0)
    assert bool(ref.fell_over) and bool(res.fell_over)
    assert float(res.final_state.time) == float(ref.final_state.time) < 39 * dt
    np.testing.assert_allclose(res.final_state.pos.numpy(), np.asarray(ref.final_state.pos),
                               **DIST)
    for f in ("end_of_life_posterior_y", "fall_adj_post_y", "norm_final_dist"):
        np.testing.assert_allclose(float(getattr(res, f)), float(getattr(ref, f)),
                                   err_msg=f, **DIST)
    assert float(res.fall_adj_post_y) == float(res.end_of_life_posterior_y) - 2

    body = _port(_walker(feet, dtype=jnp.float32), torch.float32)
    dt = float(calc_max_dt(body)) * float(sim.dt_frac)
    out, stats = fr.fused_rollout(_expand_state(init_state(body), (1,), ()), body, sim, env,
                                  num_steps=40, dt=dt, stop_time=1.0)
    res = rollout(body, sim, env, 40, dt=dt, stop_time=1.0)
    assert bool(stats.fell_over[0]) and bool(res.fell_over)
    np.testing.assert_allclose(out.pos[0].numpy(), res.final_state.pos.numpy(),
                               rtol=5e-5, atol=1e-8)


def test_norm_dist_by_vol_online_accumulation():
    """The fused path's online NormDistByVol against a dense recomputation
    at the same cadence from the eager rollout's per-step trace (the
    post-step sample of step i is the pre-step sample of step i + 1), as
    tests/test_fused_features.py holds the JAX kernel."""
    body = _port(_walker(dtype=jnp.float32), torch.float32)
    sim = SimParams(init_cm_time=0.002, stop_condition_value=1.0)
    env = EnvParams(norm_dist_by_vol=True, time_between_traces=0.0007)
    steps = 60
    dt = float(calc_max_dt(body)) * float(sim.dt_frac)
    _, stats = fr.fused_rollout(_expand_state(init_state(body), (1,), ()), body, sim, env,
                                num_steps=steps, dt=dt)
    res = rollout(body, sim, env, steps + 1, dt=dt, trace_every=1)
    cms = res.cm_trace[1:steps + 1, 1].double().numpy()
    vols = res.vol_trace[1:steps + 1].double().numpy()
    times = res.trace_times[1:steps + 1].double().numpy()
    nd, last_t, prev = 0.0, -1.0, None
    for cy, vol, t in zip(cms, vols, times):
        if t > sim.init_cm_time and (prev is None or last_t + env.time_between_traces <= t):
            if prev is not None:
                avg = 0.5 * (vol + prev[1])
                nd += (cy - prev[0]) / L / (avg if avg > 0 else 1.0)
            prev, last_t = (cy, vol), t
    assert abs(nd) > 0
    np.testing.assert_allclose(float(stats.norm_dist_by_vol[0]), nd, rtol=2e-4, atol=1e-7)


def test_evaluator_paths_agree_on_needle_falling():
    """The evaluator's wiring of the needle and fall-over flags
    (`make_fused_evaluator` -> kernel flags -> `packed_metrics`) against the
    eager `rollout` of each design, as tests/test_fused_features.py holds
    the JAX package's fused evaluator against its eager batched one:
    features whose semantics do not depend on the trace cadence. (The tags
    against the JAX package's evaluator: tests/test_torch_evaluation.py.)
    Both run float32 through the same eager step; atol 1e-4 lattice units
    (a micron) as the JAX test."""
    from evosoro_tpu_torch.evo.evaluation import make_fused_evaluator

    rng = np.random.default_rng(5)
    B, n = 4, 3
    structures = np.zeros((B, n, n, 2), dtype=np.int32)
    structures[:, :, :, 0] = 3
    structures[:, :, :, 1] = 1
    structures[:, 1, 1, 1] = 7  # needle voxel
    structures[:, 0, 0, 0] = 6  # one foot (the latch cannot trip)
    phases = rng.uniform(-1, 1, size=(B, n, n, 2)).astype(np.float32)
    sim = SimParams(init_cm_time=0.001, stop_condition_value=1.0)
    env = EnvParams(needle_in_haystack=True, falling_prohibited=True, lattice_dim=L)
    steps, stop = 40, 1.0
    palette = palette_from_list(evosoro_default_palette())
    fn = make_fused_evaluator(palette, (n, n, 2), steps, ("phase_offset",), L, sim, env,
                              device="cpu")
    m = fn(structures, {"phase_offset": phases}, [env] * B, stop)
    for b in range(B):
        body = build_body(structures[b], palette, lattice_dim=L, phase_offset=phases[b])
        res = rollout(body, sim, env, steps, dt=calc_max_dt(body) * sim.dt_frac,
                      stop_time=stop)
        for key in ("norm_final_dist", "push_dist", "end_of_life_posterior_y"):
            np.testing.assert_allclose(m[key][b], float(getattr(res, key)), rtol=3e-3,
                                       atol=1e-4, err_msg=key)
        assert (m["found_needle"][b] > 0.5) == bool(res.found_needle)
    assert (m["found_needle"] > 0.5).all() and not m["diverged"].any()


def test_packed_metrics_and_outputs_equal_jax():
    """The feature keywords of `packed_metrics` and `stats_to_outputs` on
    the same random packed outputs: the same numbers as JAX's."""
    rng = np.random.default_rng(3)
    B, V = 6, 18
    state = rng.normal(0, 0.02, size=(B, fr.C_S, V)).astype(np.float32)
    body = np.zeros((B, fr.C_B, V), np.float32)
    body[:, fr._B_MASS] = rng.uniform(0.5, 1.5, size=(B, V))
    body[:, fr._B_MAT] = rng.integers(1, 5, size=(B, V))
    body[:4, fr._B_MAT, 3] = 7.0
    stats = rng.normal(0, 1, size=(B, fr.C_STAT)).astype(np.float32)
    stats[:, fr._S_INV_MASS] = 1.0 / body[:, fr._B_MASS].sum(1)
    stats[:, fr._S_DIV] = [0, 1, 0, 0, 0, 0]
    stats[:, fr._S_FELL] = [0, 0, 1, 0, 1, 0]
    Vp = 128
    padded = [np.pad(a, ((0, 0), (0, 0), (0, Vp - V))) for a in (state, body)]
    for kw in (dict(), dict(ndbv=True, falling=True, needle=True, window=True, grid_z=4),
               dict(falling=True, grid_z=3), dict(needle=True)):
        ref = jfr.packed_metrics(jnp.asarray(padded[0]), jnp.asarray(padded[1]),
                                 jnp.asarray(stats), L, **kw)
        got = fr.packed_metrics(torch.as_tensor(state), torch.as_tensor(body),
                                torch.as_tensor(stats), L, **kw)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=2e-6,
                                       atol=1e-7, err_msg=f"{k} {kw}")
    ref = jfr.stats_to_outputs(jnp.asarray(stats))
    got = fr.stats_to_outputs(torch.as_tensor(stats))
    for f in ("fell_over", "norm_dist_by_vol", "norm_regime_dist_by_vol",
              "norm_frozen_dist_by_vol", "norm_window_dist", "win_prev_dist", "win_count",
              "ini_needle", "end_of_life_posterior_y"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))


@pytest.mark.parametrize("case", ["plain", "needle_falling", "ndbv_no_traces",
                                  "window_12", "window_13", "three_sources",
                                  "four_sources"])
def test_supports_agrees_with_jax(case):
    """`supports()` on the feature envelope: at most 12 window slots and 3
    sources, a positive time between traces for windows and NormDistByVol."""
    jb = _walker(dtype=jnp.float32)
    src = [dict(pos=(0.1 * k, 0, 0), enabled=True) for k in range(4)]
    env = dict(plain=JEnv(),
               needle_falling=JEnv(needle_in_haystack=True, falling_prohibited=True),
               ndbv_no_traces=JEnv(norm_dist_by_vol=True, time_between_traces=0.0),
               window_12=JEnv(num_trace_steps_in_window=12),
               window_13=JEnv(num_trace_steps_in_window=13),
               three_sources=JEnv(sources=j_make_sources(src[:3])),
               four_sources=JEnv(sources=j_make_sources(src)))[case]
    sim = JSim()
    got = fr.supports(_port(jb, torch.float32), convert.sim_params_from_jax(sim),
                      convert.env_params_from_jax(env))
    assert got == jfr.supports(jb, sim, env)
