"""The port's `rollout` / `RolloutResult` (`evosoro_tpu_torch.core.rollout`)
held against the JAX package's on the same inputs.

Inputs come from a numpy seed and go through both packages. The JAX side is
`jax.vmap(rollout)` over the candidates' control sequences; the port takes
the same batch as a leading dimension.

Both run in float64 here (the JAX package's own tests run its eager path so,
tests/conftest.py). In float32, once anything actuates (here from the first
step, through the controls), XLA's FMA contraction against eager torch's
separate roundings, amplified by the reference's quaternion snap to
identity, moves voxels by ~1e-5 m within 24 steps (ROADMAP §C), which is
10 % of the distances these short rollouts cover and would hide a wrong
reduction. In float64 the rollouts with controls agree to 1e-15 m; without
controls the voxels barely rotate, the snap (`w >= 1`) flips on the last
bit, and the two differ by up to 1e-10 m. So every field is held at: metres
rtol 1e-7 / atol 1e-9 (a voxel is 0.01 m), distances in lattice units rtol
1e-5 / atol 1e-8, times at rtol 1e-12, counts and flags exactly.
The float32 path is held against JAX by tests/test_torch_fused_control.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.core.rollout import rollout as j_rollout
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.core import EnvParams, SimParams, init_state, rollout

torch.set_num_threads(1)

STEPS, KNOTS, BATCH = 24, 3, 3
DIST = dict(rtol=1e-5, atol=1e-8)  # lattice units
METRES = dict(rtol=1e-7, atol=1e-9)
TIME = dict(rtol=1e-12, atol=1e-18)
# a gentle actuation, so the robots stay on the floor through the horizon
ENV_KW = dict(temp_amplitude=5.0)

_DIST_FIELDS = ("norm_final_dist", "final_dist", "final_dist_y",
                "norm_regime_dist", "norm_frozen_dist", "anterior_dist",
                "posterior_dist", "anterior_y", "posterior_y",
                "end_of_life_posterior_y", "fall_adj_post_y", "push_dist",
                "norm_window_dist")
_EXACT_FIELDS = ("fell_over", "num_touching_floor",
                 "num_non_feet_touching_floor", "found_needle", "diverged")

# case -> (with controls, stop_time in steps, trace_every)
_CASES = {
    "plain": (False, None, 0),
    "controls_stop_time": (True, 9.5, 0),
    "controls_trace": (True, None, 5),
}


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _design():
    rng = np.random.default_rng(11)
    structure = rng.integers(0, 7, size=(4, 3, 3)).astype(np.int32)
    structure[1, 1, 0] = 3
    structure[2, 1, 0] = 6  # a "foot" material, for the touch counts
    phase = rng.uniform(-1, 1, size=structure.shape)
    jb = j_build_body(structure, j_palette(j_default_palette()),
                      phase_offset=phase, dtype=jnp.float64)
    dt = float(j_calc_max_dt(jb)) * 0.9
    u = rng.uniform(-0.05, 0.05, size=(BATCH, KNOTS) + structure.shape)
    return jb, dt, u


def _port(jb, state=None):
    body = convert.body_from_numpy(_np(jb), dtype=torch.float64)
    if state is None:
        return body
    return body, convert.state_from_numpy(_np(state), dtype=torch.float64)


@pytest.fixture(scope="module", params=list(_CASES))
def both(request):
    """(JAX result, port result) of one case."""
    with_u, stop_steps, trace_every = _CASES[request.param]
    jb, dt, u = _design()
    # the CoM capture lands on step 4 and the end of life on step 16
    sim_kw = dict(init_cm_time=3.5 * dt, stop_condition_value=15.5 * dt,
                  afterlife_time=2.0 * dt)
    stop = None if stop_steps is None else stop_steps * dt
    state = j_init_state(jb, dtype=jnp.float64)

    def one(ui):
        return j_rollout(jb, JSim(**sim_kw), JEnv(**ENV_KW), num_steps=STEPS, dt=dt,
                         state=state, trace_every=trace_every,
                         control_sequence=ui if with_u else None, stop_time=stop)

    ref = _np(jax.jit(jax.vmap(one))(jnp.asarray(u)))
    body, pstate = _port(jb, state)
    out = rollout(body, SimParams(**sim_kw), EnvParams(**ENV_KW), num_steps=STEPS,
                  dt=dt, state=pstate, trace_every=trace_every, stop_time=stop,
                  control_sequence=torch.as_tensor(u) if with_u else None)
    return request.param, ref, out, dt


def test_rollout_result_fields_match_jax(both):
    case, ref, out, dt = both
    # without controls the port's result is unbatched; JAX's rows are equal
    lead, sel = ((BATCH,), slice(None)) if _CASES[case][0] else ((), 0)
    for name in _DIST_FIELDS:
        got = getattr(out, name).numpy()
        assert got.shape == lead, name
        np.testing.assert_allclose(got, getattr(ref, name)[sel], err_msg=name, **DIST)
    for name in _EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      getattr(ref, name)[sel], err_msg=name)
    for name in ("ini_cm", "final_cm"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   getattr(ref, name)[sel], err_msg=name, **METRES)
    np.testing.assert_allclose(out.lifetime.numpy(), ref.lifetime[sel], **TIME)
    assert out.source_min_dist is None and out.source_avg_min_dist is None
    # the captures happened inside the horizon, and the robot stands on feet
    if case != "controls_stop_time":  # frozen before the end of life
        assert float(np.abs(ref.end_of_life_posterior_y).max()) > 0
        assert int(ref.num_non_feet_touching_floor.max()) > 0
    assert not np.allclose(ref.ini_cm, ref.final_cm, atol=0, rtol=1e-7)


def test_rollout_final_state_matches_jax(both):
    case, ref, out, dt = both
    sel = slice(None) if _CASES[case][0] else 0
    fs, rs = out.final_state, ref.final_state
    np.testing.assert_allclose(fs.pos.numpy(), rs.pos[sel], **METRES)
    np.testing.assert_allclose(fs.quat.numpy(), rs.quat[sel], rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(fs.linmom.numpy(), rs.linmom[sel], rtol=1e-4, atol=1e-10)
    np.testing.assert_allclose(fs.scale.numpy(), rs.scale[sel], rtol=1e-12)
    np.testing.assert_allclose(fs.time.numpy(), rs.time[sel], **TIME)
    np.testing.assert_array_equal(fs.small_angle.numpy(), rs.small_angle[sel])
    if case == "controls_stop_time":
        # frozen at the first step whose time passed the stop time
        np.testing.assert_allclose(fs.time.numpy(), 10 * dt, rtol=1e-9)
    if case == "controls_trace":
        # the controls moved the scale, differently for every candidate
        assert np.abs(rs.scale[0] - rs.scale[1]).max() > 1e-5


def test_rollout_trace_matches_jax(both):
    case, ref, out, dt = both
    if _CASES[case][2] == 0:
        assert out.cm_trace is None and out.vol_trace is None
        assert out.trace_times is None and ref.cm_trace is None
        return
    n = len(range(0, STEPS, 5))
    assert out.cm_trace.shape == (BATCH, n, 3) == ref.cm_trace.shape
    np.testing.assert_allclose(out.cm_trace.numpy(), ref.cm_trace, **METRES)
    np.testing.assert_allclose(out.vol_trace.numpy(), ref.vol_trace, rtol=1e-12)
    np.testing.assert_allclose(out.trace_times.numpy(), ref.trace_times, **TIME)


def test_rollout_batches_state_and_body_shapes():
    """An unbatched state with batched controls is broadcast; a batched state
    with no controls keeps its batch; no state starts from rest."""
    jb, dt, u = _design()
    body = _port(jb)
    sim, env = SimParams(init_cm_time=0.0), EnvParams()
    a = rollout(body, sim, env, 3, dt=dt, control_sequence=torch.as_tensor(u))
    st = init_state(body)
    batched = st.replace(**{f.name: getattr(st, f.name)[None].expand(
        (BATCH,) + tuple(getattr(st, f.name).shape)).clone()
        for f in dataclasses.fields(st) if torch.is_tensor(getattr(st, f.name))})
    b = rollout(body, sim, env, 3, dt=dt, state=batched,
                control_sequence=torch.as_tensor(u))
    assert a.final_cm.shape == (BATCH, 3)
    assert torch.equal(a.final_state.pos, b.final_state.pos)
    c = rollout(body, sim, env, 3, dt=dt, state=batched)
    assert c.norm_final_dist.shape == (BATCH,)
    assert torch.equal(c.final_state.pos[0], c.final_state.pos[2])


@pytest.mark.parametrize("what", ["needle", "falling", "ndbv", "window",
                                  "stop_condition", "volume", "control_shape"])
def test_rollout_refuses_what_is_not_ported(what):
    jb, dt, u = _design()
    body = _port(jb)
    sim, env, kw = SimParams(), EnvParams(), {}
    err = NotImplementedError
    if what == "needle":
        env = EnvParams(needle_in_haystack=True)
    elif what == "falling":
        env = EnvParams(falling_prohibited=True)
    elif what == "ndbv":
        env = EnvParams(norm_dist_by_vol=True)
    elif what == "window":
        env = EnvParams(num_trace_steps_in_window=4)
    elif what == "stop_condition":
        kw = dict(stop_condition_type=1)
    elif what == "volume":
        sim = SimParams(volume_effects_enabled=True)
    else:
        kw, err = dict(control_sequence=torch.zeros(2, 5, 5, 5)), ValueError
    with pytest.raises(err):
        rollout(body, sim, env, 2, dt=dt, **kw)
