"""The port's fused rollout with the MPC control-knot channel and the
segmented mode, held against the JAX package and against the port's own
eager rollout.

On the CPU `fused_call` runs K1's plain version, so these check the host
side (packing of the controls, the knot clock, the segment offset, the
runner) and the plain version's arithmetic; the kernel itself is held
against that plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py). The JAX kernel runs in interpret mode, as
tests/test_fused_rollout.py:126-150 runs it.

Tolerances against JAX, float32: channel by channel at 2 steps with
the JAX package's own kernel-vs-jnp bounds (pos rtol 2e-5, quat rtol 2e-5,
linmom rtol 1e-4, scale rtol 1e-5 with controls). The controls act from the
first step, so the quiet prefix before the actuation onset that
tests/test_torch_fused_rollout.py compares over (8 steps) does not exist
here: at step 3 the quaternion snap to identity already turns the
last-bit difference between XLA's FMA contraction and eager torch into
4e-4 in a quaternion and, by step 8, 3e-6 m in a position (ROADMAP §C).
Past step 2 the scale, which is set anew from the knots every step, is
still held at rtol 1e-5 (a wrong knot or offset shows there at once),
positions at atol 2e-5 m, and the metrics at rtol 5e-3 / atol 5e-5 in
lattice units: these 20-step rollouts move the robots 4e-4 to 2e-3 lattice
units, and the two packages differ by up to 1.6e-5 of them, so that
file's atol 1e-5 is too tight here. Port against port (fused path, eager
rollout, segment chain) is held bit for bit: the same eager step runs
underneath.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.core import rollout
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)
jfr = importlib.import_module("evosoro_tpu.ops.fused_rollout")

B, N, K = 8, 4, 4
V = N ** 3
METRIC = dict(rtol=5e-3, atol=5e-5)


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _setup(seed=2, **sim_kw):
    rng = np.random.default_rng(seed)
    structure = rng.integers(0, 5, size=(N, N, N)).astype(np.int32)
    structure[N // 2, N // 2, 0] = 3
    phase = rng.uniform(-1, 1, size=(N, N, N))
    jb = j_build_body(structure, j_palette(j_default_palette()),
                      phase_offset=phase, dtype=jnp.float32)
    sim, env = JSim(**sim_kw), JEnv()
    dt = jnp.asarray(j_calc_max_dt(jb), jnp.float32) * jnp.asarray(sim.dt_frac, jnp.float32)
    state = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape),
        j_init_state(jb, dtype=jnp.float32))
    u = np.random.default_rng(0).uniform(
        -0.05, 0.05, size=(B, K, N, N, N)).astype(np.float32)
    return jb, sim, env, dt, state, u


def _port(jb, sim, env, state):
    return (convert.body_from_numpy(_np(jb)), convert.sim_params_from_jax(sim),
            convert.env_params_from_jax(env), convert.state_from_numpy(_np(state)))


@pytest.mark.parametrize("steps", [2, 20])
def test_fused_rollout_with_controls_matches_jax_kernel(steps):
    jb, sim, env, dt, state, u = _setup()
    ref, ref_stats = jfr.fused_rollout(state, jb, sim, env, num_steps=steps, dt=dt,
                                       control_sequence=jnp.asarray(u), interpret=True)
    body, psim, penv, pstate = _port(jb, sim, env, state)
    out, stats = fr.fused_rollout(pstate, body, psim, penv, steps, float(dt),
                                  control_sequence=torch.as_tensor(u))
    np.testing.assert_allclose(stats.time.numpy(), np.asarray(ref_stats.time), rtol=1e-6)
    if steps <= 2:
        np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos), rtol=2e-5, atol=1e-9)
        np.testing.assert_allclose(out.quat.numpy(), np.asarray(ref.quat), rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(out.linmom.numpy(), np.asarray(ref.linmom),
                                   rtol=1e-4, atol=1e-10)
        np.testing.assert_allclose(out.scale.numpy(), np.asarray(ref.scale), rtol=1e-5)
        np.testing.assert_array_equal(out.small_angle.numpy(), np.asarray(ref.small_angle))
    else:
        fit = fr.locomotion_fitness(out, body, stats)
        ref_fit = jfr.locomotion_fitness(ref, jb, ref_stats)
        np.testing.assert_allclose(fit.numpy(), np.asarray(ref_fit), **METRIC)
        np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos), rtol=0, atol=2e-5)
        # the scale follows the knots exactly: it is set anew every step
        np.testing.assert_allclose(out.scale.numpy(), np.asarray(ref.scale), rtol=1e-5)
    # every robot got its own controls
    assert float((out.scale[0] - out.scale[1]).abs().max()) > 1e-5


def test_fused_rollout_with_controls_equals_eager_rollout():
    """The fused path's plain version and the eager `rollout` run the same
    step with the same knot clock: final states bit for bit."""
    jb, sim, env, dt, state, u = _setup(init_cm_time=0.0)
    body, psim, penv, pstate = _port(jb, sim, env, state)
    steps = 10
    out, stats = fr.fused_rollout(pstate, body, psim, penv, steps, float(dt),
                                  control_sequence=torch.as_tensor(u))
    res = rollout(body, psim, penv, num_steps=steps, dt=float(dt), state=pstate,
                  control_sequence=torch.as_tensor(u))
    for f in ("pos", "quat", "linmom", "angmom", "scale"):
        assert torch.equal(getattr(out, f), getattr(res.final_state, f)), f
    torch.testing.assert_close(stats.ini_cm, res.ini_cm, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(fr.locomotion_fitness(out, body, stats),
                               res.norm_final_dist, rtol=1e-4, atol=1e-7)


def _packed(init_cm_time=0.0):
    jb, sim, env, dt, state, u = _setup(seed=5, init_cm_time=init_cm_time)
    body, psim, penv, pstate = _port(jb, sim, env, state)
    stats = fr.make_stats(body, B, float(dt), psim, penv)
    kw = dict(grid_shape=body.grid_shape,
              scalars=fr.kernel_scalars(body.nominal_size, psim, penv),
              flags=dict(fr.kernel_env_flags(psim, penv), **fr.body_flags(body),
                         collision=False))
    ctrl = fr._flat(torch.as_tensor(u), (B, K)).contiguous()
    return (fr.pack_state(pstate), fr.pack_body(body), stats), kw, ctrl


def test_segmented_chain_equals_whole():
    """Three 8-step segments with seg_base 0, 8, 16 of a 24-step rollout
    reproduce one 24-step call exactly: same knot boundaries through the
    global step, the IniCM seed only at global step 0
    (tests/test_fused_diff.py:35-60 asks atol 1e-7 of the JAX kernels)."""
    (state, body, stats), kw, ctrl = _packed()
    whole, whole_st = fr.fused_call(state, body, stats, control_packed=ctrl,
                                    n_knots=K, num_steps=24, **kw)
    seg_kw = dict(kw, flags=dict(kw["flags"], segmented=True))
    st, ss = state, stats
    for base in (0, 8, 16):
        st, ss = fr.fused_call(st, body, ss, control_packed=ctrl, n_knots=K,
                               num_steps=8, seg_base=base, total_steps=24, **seg_kw)
    assert torch.equal(st, whole) and torch.equal(ss, whole_st)
    # without the global clock the second segment would restart at knot 0
    st2, ss2 = fr.fused_call(state, body, stats, control_packed=ctrl, n_knots=K,
                             num_steps=8, **kw)
    st2, _ = fr.fused_call(st2, body, ss2, control_packed=ctrl, n_knots=K,
                           num_steps=8, **kw)
    mid, _ = fr.fused_call(state, body, stats, control_packed=ctrl, n_knots=K,
                           num_steps=16, total_steps=24, **kw)
    assert not torch.equal(st2[:, fr._SCALE], mid[:, fr._SCALE])


def test_segmented_chain_matches_jax_kernel():
    """The same chain through the JAX kernel's segment mode, held as metrics
    (24 actuated steps)."""
    jb, sim, env, dt, state, u = _setup(seed=5, init_cm_time=0.0)
    (pstate, body, stats), kw, ctrl = _packed()
    Vp = 128
    jstats = jfr.make_stats(jb, B, dt, sim, env, None, jnp.float32)
    jkw = dict(grid_shape=(N, N, N), batch_block=8, n_knots=K, interpret=True,
               scalars=tuple(sorted(jfr.kernel_scalars(jb.nominal_size, sim, env).items())),
               prec=jfr.DEFAULT_PRECISION)
    flags = dict(jfr.kernel_env_flags(sim, env), nonlinear=False, mdl_data=False,
                 bc=False, collision=False, fluid_mesh=False, use_init_size=False,
                 use_final_size=False, use_growth_t=False, use_final_phase=False,
                 use_final_ad=False, ballistic=False, segmented=True)
    sp = jfr.pack_state(state, Vp)
    bp = jfr.pack_body(jb, Vp)
    jctrl = jfr._flat(jnp.asarray(u), Vp)
    for base in (0, 8, 16):
        sp, jstats = jfr._fused_call(
            sp, bp, jstats, jctrl, None, None, None, jnp.int32(base), num_steps=8,
            total_steps=24, flags=tuple(sorted(flags.items())), **jkw)
    seg_kw = dict(kw, flags=dict(kw["flags"], segmented=True))
    st, ss = pstate, stats
    for base in (0, 8, 16):
        st, ss = fr.fused_call(st, body, ss, control_packed=ctrl, n_knots=K,
                               num_steps=8, seg_base=base, total_steps=24, **seg_kw)
    got = fr.packed_metrics(st, body, ss, 0.01)
    ref = jfr.packed_metrics(sp, bp, jstats, 0.01)
    np.testing.assert_allclose(got["norm_final_dist"].numpy(),
                               np.asarray(ref["norm_final_dist"]), **METRIC)
    np.testing.assert_allclose(ss[:, fr._S_TIME].numpy(),
                               np.asarray(jstats[:, jfr._S_TIME]), rtol=1e-6)
    np.testing.assert_allclose(st[:, fr._SCALE].numpy(),
                               np.asarray(sp[:, jfr._SCALE, :V]), rtol=1e-5)


def test_zero_knots_leave_the_rollout_unchanged():
    """K = 0 is the call without controls; controls of zeros add exactly
    nothing; one robot's knots move that robot only."""
    (state, body, stats), kw, ctrl = _packed(init_cm_time=0.0005)
    base, base_st = fr.fused_call(state, body, stats, num_steps=12, **kw)
    zero, zero_st = fr.fused_call(state, body, stats, num_steps=12, n_knots=K,
                                  control_packed=torch.zeros_like(ctrl), **kw)
    assert torch.equal(base, zero) and torch.equal(base_st, zero_st)
    one = torch.zeros_like(ctrl)
    one[3] = ctrl[3]
    out, _ = fr.fused_call(state, body, stats, num_steps=12, n_knots=K,
                           control_packed=one, **kw)
    others = torch.arange(B) != 3
    assert torch.equal(out[others], base[others])
    assert not torch.equal(out[3], base[3])


def test_runner_matches_jax_runner():
    """`FusedBatchRunner.run` on the same controls as the JAX runner (in
    interpret mode): the metrics of every candidate."""
    jb, sim, env, dt, state, u = _setup(init_cm_time=0.0)
    steps = 20
    jr = jfr.FusedBatchRunner(jb, sim, env, batch=B, num_steps=steps, num_knots=K,
                              dt=dt, interpret=True)
    ref = jr.run(jnp.asarray(u))
    body, psim, penv, _ = _port(jb, sim, env, state)
    runner = fr.FusedBatchRunner(body, psim, penv, batch=B, num_steps=steps,
                                 num_knots=K, dt=float(dt))
    got = runner.run(torch.as_tensor(u))
    assert set(got) <= set(ref)
    assert float(np.abs(np.asarray(ref["norm_final_dist"])).max()) > 1e-4
    for k in ("norm_final_dist", "final_dist_y"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **METRIC)
    for k in ("final_cm", "ini_cm"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4,
                                   atol=2e-7, err_msg=k)
    np.testing.assert_allclose(got["final_time"].numpy(), np.asarray(ref["final_time"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(got["diverged"].numpy(), np.asarray(ref["diverged"]))
    # a second run on other controls reuses the packed tensors untouched
    again = runner.run(torch.as_tensor(u))
    assert torch.equal(again["norm_final_dist"], got["norm_final_dist"])


@pytest.mark.parametrize("what", ["shape", "dtype", "knots_without_controls",
                                  "controls_without_knots", "segmented_without_base",
                                  "base_without_segmented", "segmented_without_total"])
def test_fused_call_checks_controls_and_segments(what, monkeypatch):
    (state, body, stats), kw, ctrl = _packed()
    monkeypatch.setattr(fr, "fused_rollout_plain", None)  # must raise before it runs
    args = dict(control_packed=ctrl, n_knots=K, num_steps=4)
    err = ValueError
    if what == "shape":
        args["control_packed"] = ctrl[:, :, :-1].contiguous()
    elif what == "dtype":
        args["control_packed"], err = ctrl.double(), TypeError
    elif what == "knots_without_controls":
        args["control_packed"] = None
    elif what == "controls_without_knots":
        args["n_knots"] = 0
    elif what == "segmented_without_base":
        kw = dict(kw, flags=dict(kw["flags"], segmented=True))
        args["total_steps"] = 8
    elif what == "base_without_segmented":
        args.update(seg_base=0, total_steps=8)
    else:
        kw = dict(kw, flags=dict(kw["flags"], segmented=True))
        args["seg_base"] = 0
    with pytest.raises(err):
        fr.fused_call(state, body, stats, **args, **kw)
