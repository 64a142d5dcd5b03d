"""The port's linear development held against the JAX package on the same
inputs, made with numpy from a seed.

- `devo_params_from_vxa` equals JAX's bit for bit (both are numpy on the
  host, with the reference's float32 quantisation of the bounds and of the
  start of growth);
- the eager step with development fields against JAX in float64: the scale
  (the ramps' own output) at rtol 1e-12 over 80 steps, metres at rtol 1e-7 /
  atol 1e-9 (the quaternion snap flips on the last bit, as on land);
- `fused_rollout` on CPU tensors (the plain version of K1's development
  variant) against the JAX Pallas kernel in interpret mode, float32, on the
  body of tests/test_fused_rollout.py `test_fused_devo_growth_matches_jnp`,
  at that test's tolerances: scale rtol 2e-5 atol 1e-9, pos rtol 5e-5 atol
  1e-8.
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import devo_params_from_vxa as j_devo_params
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.core.step import sim_step as j_sim_step
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.core import EnvParams, SimParams, devo_params_from_vxa, sim_step
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)
jfr = importlib.import_module("evosoro_tpu.ops.fused_rollout")
SHAPE = (3, 4, 2)


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.mark.parametrize("given", [
    ("initialvoxelsize",), ("finalvoxelsize",), ("initialvoxelsize", "finalvoxelsize"),
    ("growthtime", "startgrowthtime"), ("startgrowthtime",),
    ("initialvoxelsize", "finalvoxelsize", "growthtime", "startgrowthtime"), ()])
@pytest.mark.parametrize("relative", [False, True])
def test_devo_params_from_vxa_equal_jax(given, relative):
    rng = np.random.default_rng(len(given) + 7 * relative)
    raw = {k: None for k in ("initialvoxelsize", "finalvoxelsize", "growthtime",
                             "startgrowthtime")}
    for k in given:
        lo = -1.0 if k.endswith("size") else 0.0
        raw[k] = rng.uniform(lo, 1.0, size=SHAPE)
    kw = dict(stop_condition_value=10.0, init_cm_time=0.5, min_temp_fact=0.4,
              mid_life_freeze_time=1.3 if relative else 0.0,
              parent_lifetime=7.7 if relative else 0.0)
    ekw = dict(growth_amplitude=0.8, min_growth_time=0.05 if relative else 0.0,
               onset_relative=relative, termination_relative=relative)
    structure = np.ones(SHAPE, dtype=np.int32)
    ours = devo_params_from_vxa(raw, SimParams(**kw), EnvParams(**ekw), 0.01, structure)
    theirs = j_devo_params(raw, JSim(**kw), JEnv(**ekw), 0.01, structure)
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].dtype == np.asarray(theirs[k]).dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    if "startgrowthtime" in given:  # stored as float32 before growth reads it
        start = ours["start_growth_time"]
        np.testing.assert_array_equal(start, np.float64(np.float32(start)))


def test_devo_params_read_only_what_the_reference_reads():
    """The Sim container of the evolution layer has no `parent_lifetime`;
    the lifetime then falls back to the stop condition."""
    sim = types.SimpleNamespace(stop_condition_value=5.0, init_cm_time=1.0,
                                mid_life_freeze_time=0.0, min_temp_fact=0.1)
    env = EnvParams(growth_amplitude=0.5, onset_relative=True)
    raw = dict(finalvoxelsize=np.full(SHAPE, 0.5), startgrowthtime=np.full(SHAPE, 0.5))
    out = devo_params_from_vxa(raw, sim, env, 0.01, np.ones(SHAPE, np.int32))
    np.testing.assert_allclose(out["final_voxel_size"], 0.0125)
    np.testing.assert_allclose(out["start_growth_time"], 3.0)
    np.testing.assert_allclose(out["growth_time"], 2.0)
    assert "initial_voxel_size" not in out


def _growth_body(n, seed, dtype, extras):
    """The body of tests/test_fused_rollout.py:158-198: an all-muscle block
    with random initial and final sizes and growth windows."""
    rng = np.random.default_rng(seed)
    structure = np.full((n, n, n), 3, dtype=np.int32)
    phase = rng.uniform(-1, 1, size=(n, n, n))
    L = 0.01
    kw = dict(
        initial_voxel_size=(1.0 + 0.8 * rng.uniform(-1, 1, size=(n, n, n))) * L,
        final_voxel_size=(1.0 + 0.8 * rng.uniform(-1, 1, size=(n, n, n))) * L,
        growth_time=rng.uniform(0.001, 0.004, size=(n, n, n)),
        start_growth_time=rng.uniform(0.0005, 0.002, size=(n, n, n)))
    if extras:
        kw.update(final_phase_offset=rng.uniform(-1, 1, size=(n, n, n)),
                  temp_amp_damp=rng.uniform(0.5, 1.0, size=(n, n, n)),
                  final_temp_amp_damp=rng.uniform(0.2, 1.0, size=(n, n, n)))
    return j_build_body(structure, j_palette(j_default_palette()), phase_offset=phase,
                        dtype=dtype, **kw)


@pytest.mark.parametrize("freeze,extras", [(0.0, False), (0.0, True), (0.002, True)])
def test_eager_devo_step_matches_jax_in_float64(freeze, extras):
    jb = _growth_body(3, 7, jnp.float64, extras)
    sim = JSim(init_cm_time=0.001, min_temp_fact=0.4, stop_condition_value=0.008,
               mid_life_freeze_time=freeze)
    env = JEnv(growth_amplitude=0.8)
    dt = float(j_calc_max_dt(jb)) * 0.9
    body = convert.body_from_numpy(_np(jb), dtype=torch.float64)
    assert body.using_initial_voxel_size and body.using_final_voxel_size
    assert body.using_final_phase_offset == extras
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)
    st = j_init_state(jb, dtype=jnp.float64)
    s = convert.state_from_numpy(_np(st), dtype=torch.float64)
    step = jax.jit(lambda x: j_sim_step(x, jb, sim, env, dt))
    seen = set()
    for i in range(80):
        st, s = step(st), sim_step(s, body, psim, penv, dt)
        if i in (1, 39, 79):
            np.testing.assert_allclose(s.scale.numpy(), np.asarray(st.scale), rtol=1e-12)
            np.testing.assert_allclose(s.pos.numpy(), np.asarray(st.pos),
                                       rtol=1e-7, atol=1e-9)
        seen.add(round(float(s.scale.max()) / 0.01, 2))
    assert float(s.time) > 0.004 and len(seen) > 5  # the sizes moved
    assert float((s.scale - 0.01).abs().max()) > 1e-3
    assert not bool(s.diverged)


def test_fused_devo_rollout_matches_jax_kernel():
    jb = _growth_body(4, 7, jnp.float32, False)
    sim = JSim(init_cm_time=0.001, min_temp_fact=0.4)
    env = JEnv(growth_amplitude=0.8)
    dt = jnp.asarray(j_calc_max_dt(jb), jnp.float32) * jnp.asarray(sim.dt_frac, jnp.float32)
    state = j_init_state(jb, dtype=jnp.float32)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), state)
    ref, _ = jfr.fused_rollout(batched, jb, sim, env, num_steps=80, dt=dt,
                               interpret=True, batch_block=2)
    body = convert.body_from_numpy(_np(jb))
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)
    assert fr.supports(body, psim, penv)
    flags = fr.launch_flags(body, psim, penv)
    assert flags["use_init_size"] and flags["use_final_size"] and flags["use_growth_t"]
    assert not flags["use_final_phase"] and not flags["use_final_ad"]
    out, stats = fr.fused_rollout(convert.state_from_numpy(_np(batched)), body, psim,
                                  penv, num_steps=80, dt=float(dt))
    assert float(np.abs(np.asarray(ref.scale) - 0.01).max()) > 1e-3
    np.testing.assert_allclose(out.scale.numpy(), np.asarray(ref.scale),
                               rtol=2e-5, atol=1e-9)
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos), rtol=5e-5, atol=1e-8)
    assert not bool(stats.diverged.any())
    # the development flags are what made it grow: the land step on the
    # same packed tensors only actuates
    land = body.replace(using_initial_voxel_size=False, using_final_voxel_size=False,
                        using_growth_time=False)
    flat, _ = fr.fused_rollout(convert.state_from_numpy(_np(batched)), land, psim, penv,
                               num_steps=80, dt=float(dt))
    assert float((flat.scale - out.scale).abs().max()) > 1e-3


def test_ballistic_devo_and_fluid_devo_keep_their_rules():
    """In a fluid the development flags are inert (the land_water actuation
    bypasses them); ballistic development runs on land with an evolved
    final size and raises by name elsewhere (in a fluid the JAX kernel
    rebases from ramps its actuation ignores, its eager step not at all).
    The reverse-mode kernel differentiates development and water, not
    ballistic development (as the JAX package's `_diff_envelope_ok`)."""
    flags = dict(fluid=True, use_init_size=True, use_final_size=True, temp_enabled=True)
    assert fr._flag_bits(flags) == fr._K1_FLAG_BITS["fluid"] | fr._K1_FLAG_BITS["temp_enabled"]
    assert fr._flag_bits(dict(flags, fluid=False)) & fr._K1_FLAG_BITS["use_init_size"]
    with pytest.raises(NotImplementedError, match="ballistic"):
        fr.check_envelope(dict(ballistic=True), {})
    with pytest.raises(NotImplementedError, match="ballistic"):
        fr.check_envelope(dict(flags, ballistic=True, window=True, n_win=4), {"tb": 0.01})
    land = dict(use_final_size=True, ballistic=True, window=True, n_win=4, temp=True,
                temp_enabled=True)
    fr.check_envelope(land, {"tb": 0.01})
    assert fr._flag_bits(land) & fr._K1_FLAG_BITS["ballistic"]
    assert fr.diff_envelope_ok(dict(use_final_size=True), {})
    assert fr.diff_envelope_ok(dict(fluid=True), {})
    assert not fr.diff_envelope_ok(dict(use_final_size=True, ballistic=True), {})


def _growing_walker(dtype=torch.float64):
    """tests/test_devo_ballistic.py's growing walker: a 3x3x2 block, muscle
    below and tissue above, growing from L to 1.4 L over 0.15 s from 0.02 s."""
    from evosoro_tpu_torch.core import build_body, evosoro_default_palette, palette_from_list

    rng = np.random.default_rng(11)
    structure = np.zeros((3, 3, 2), dtype=np.int32)
    structure[:, :, 0] = 3
    structure[:, :, 1] = 1
    phase = rng.uniform(-1, 1, size=structure.shape) * (structure > 0)
    L = 0.01
    shape = structure.shape
    return build_body(structure, palette_from_list(evosoro_default_palette()),
                      lattice_dim=L, phase_offset=phase, dtype=dtype,
                      initial_voxel_size=np.full(shape, L),
                      final_voxel_size=np.full(shape, 1.4 * L),
                      growth_time=np.full(shape, 0.15),
                      start_growth_time=np.full(shape, 0.02))


def _ballistic_run(slowdown, max_slow, stop=0.1):
    """The walker in tests/test_devo_ballistic.py's setting (windows of 4
    traces, a trace every 5 ms, from 0.02 s, to `stop`), on the port's eager
    rollout in float64."""
    from evosoro_tpu_torch.core import calc_max_dt, num_steps_for, rollout

    body = _growing_walker()
    sim = SimParams(stop_condition_value=stop, init_cm_time=0.02)
    env = EnvParams(growth_amplitude=0.5, num_trace_steps_in_window=4,
                    time_between_traces=0.005, norm_dist_by_vol=True,
                    ballistic_slowdown_fact=slowdown, max_slowdown_permitted=max_slow,
                    min_growth_time=0.0)
    dt = float(calc_max_dt(body)) * float(sim.dt_frac)
    return body, rollout(body, sim, env, num_steps_for(body, sim, dt=dt), dt=dt)


def test_windows_accumulate_and_rebase_applies():
    """With every decrease of the windowed speed halting development
    (slowdown factor 1, threshold -0.5), the rebase rewrites the start of
    growth to a sim time and pulls some final size below the target (by
    0.1 s here; the JAX test runs 0.2 s)."""
    body, res = _ballistic_run(1.0, -0.5)
    devo = res.final_state.devo
    assert devo is not None and int(devo.win_count) >= 2
    assert torch.isfinite(res.final_state.pos).all()
    occ = body.occ
    assert (devo.start_growth_time[occ] > 0.02).all()
    assert (devo.final_voxel_size[occ] < 1.4 * 0.01 - 1e-9).any()


def test_zero_slowdown_fact_keeps_the_target():
    """BallisticSlowdownFact 0: the rebase keeps the final size (float32
    storage aside) while it moves the start of growth."""
    body, res = _ballistic_run(0.0, 0.1, stop=0.08)
    devo = res.final_state.devo
    np.testing.assert_allclose(devo.final_voxel_size[body.occ].numpy(), 1.4 * 0.01,
                               rtol=1e-6)
    assert (devo.start_growth_time[body.occ] > 0.02).all()


def test_ballistic_state_follows_jax():
    """The JAX package's rule: `init_state(ballistic_devo=True)` carries a
    DevoState seeded from the body's fields (the final size also as the
    bound), none without it, and `rollout` makes one exactly when windows
    run over an evolved final size. (Its fields against JAX's after a
    rollout: tests/test_torch_features.py.)"""
    from evosoro_tpu_torch.core import init_state, rollout

    body = _growing_walker()
    devo = init_state(body, ballistic_devo=True).devo
    for f, src in (("initial_voxel_size", "initial_voxel_size"),
                   ("final_voxel_size", "final_voxel_size"),
                   ("original_final_voxel_size", "final_voxel_size"),
                   ("growth_time", "growth_time"), ("start_growth_time", "start_growth_time")):
        assert torch.equal(getattr(devo, f), getattr(body, src)), f
    assert int(devo.win_count) == 0 and float(devo.win_last) == float(devo.win_prev) == 0.0
    assert init_state(body).devo is None
    sim = SimParams(stop_condition_value=0.05, init_cm_time=0.02)
    res = rollout(body, sim, EnvParams(growth_amplitude=0.5), 3, dt=1e-5)
    assert res.final_state.devo is None
    res = rollout(body, sim, EnvParams(growth_amplitude=0.5, num_trace_steps_in_window=4), 3,
                  dt=1e-5)
    assert res.final_state.devo is not None
