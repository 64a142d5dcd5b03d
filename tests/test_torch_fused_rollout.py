"""The port's fused rollout (`evosoro_tpu_torch.ops.fused_rollout`) held
against the JAX package, plus its envelope and device rules.

On the CPU the wrappers run the kernels' plain versions; the kernels
themselves are held against those on the card by
tests/test_torch_kernels_cuda.py and by chip_smoke.py.
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
from evosoro_tpu.core.rollout import rollout as j_rollout
from evosoro_tpu.core.step import sim_step as j_sim_step
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.ops import build
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)
# the module, not the function `evosoro_tpu.ops` re-exports under its name
jfr = importlib.import_module("evosoro_tpu.ops.fused_rollout")


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _jax_setup(batch, n, seed, **sim_kw):
    rng = np.random.default_rng(seed)
    structure = rng.integers(0, 5, size=(n, n, n)).astype(np.int32)
    structure[n // 2, n // 2, 0] = 3
    phase = rng.uniform(-1, 1, size=(n, n, n))
    jb = j_build_body(structure, j_palette(j_default_palette()),
                      phase_offset=phase, dtype=jnp.float32)
    sim, env = JSim(**sim_kw), JEnv()
    dt = jnp.asarray(j_calc_max_dt(jb), jnp.float32) * jnp.asarray(sim.dt_frac, jnp.float32)
    state = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape),
        j_init_state(jb, dtype=jnp.float32))
    return jb, sim, env, dt, state


def _packed_call_args(jb, sim, env, dt, state):
    body = convert.body_from_numpy(_np(jb))
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)
    ps = convert.state_from_numpy(_np(state))
    B = ps.scale.shape[0]
    stats = fr.make_stats(body, B, float(dt), psim, penv)
    kw = dict(grid_shape=body.grid_shape,
              scalars=fr.kernel_scalars(body.nominal_size, psim, penv),
              flags=dict(fr.kernel_env_flags(psim, penv), **fr.body_flags(body),
                         collision=False))
    return (fr.pack_state(ps), fr.pack_body(body), stats), kw


@pytest.fixture(scope="module")
def jax_scan():
    """The JAX sim_step trajectory, 5³, batch 2, actuated from step 8."""
    jb, sim, env, dt, state = _jax_setup(2, 5, 0, init_cm_time=0.0005)

    def run(s):
        def f(s, i):
            s = j_sim_step(s, jb, sim, env, dt)
            return s, s

        return jax.lax.scan(f, s, jnp.arange(8))[1]

    traj = jax.jit(jax.vmap(run))(state)
    return (jb, sim, env, dt, state), traj


# per channel group of the packed state: (first, last+1, rtol, atol)
_CHANNELS = dict(pos=(fr._POS, fr._POS + 3, 2e-5, 1e-9),
                 quat=(fr._QUAT, fr._QUAT + 4, 2e-5, 1e-7),
                 linmom=(fr._LIN, fr._LIN + 3, 1e-4, 1e-10),
                 angmom=(fr._ANG, fr._ANG + 3, 1e-4, 1e-10),
                 scale=(fr._SCALE, fr._SCALE + 1, 1e-6, 0.0),
                 max_strain=(fr._MAXS, fr._MAXS + 3, 1e-4, 1e-9),
                 bond_memory=(fr._LP2, fr._LA2 + 9, 1e-4, 1e-9))


@pytest.mark.parametrize("steps", [1, 8])
def test_fused_rollout_plain_matches_jax_scan(jax_scan, steps):
    """Channel by channel on the packed layout. Actuation starts at step 8
    (init_cm_time 0.0005 s); past it the quaternion's identity snap turns
    ulp-level differences (XLA contracts into FMA, eager torch does not)
    into visible jumps, so the channel check stops there."""
    setup, traj = jax_scan
    args, kw = _packed_call_args(*setup)
    out, stats = fr.fused_call(*args, num_steps=steps, **kw)
    ref_state = jax.tree_util.tree_map(lambda a: a[:, steps - 1], traj)
    ref = np.asarray(jfr.pack_state(ref_state, 128))[:, :, :125]
    for name, (a, b, rtol, atol) in _CHANNELS.items():
        np.testing.assert_allclose(out[:, a:b].numpy(), ref[:, a:b],
                                   rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_array_equal(out[:, fr._SMALL:fr._SMALL + 3].numpy(),
                                  ref[:, fr._SMALL:fr._SMALL + 3])
    np.testing.assert_allclose(stats[:, fr._S_TIME].numpy(),
                               np.asarray(ref_state.time), rtol=1e-6)


def test_locomotion_fitness_matches_jax_rollout():
    """IniCM capture and NormFinalDist against the JAX rollout past the
    actuation onset (tests/test_fused_rollout.py:82-110)."""
    jb, sim, env, dt, state = _jax_setup(4, 4, 3, init_cm_time=0.002,
                                         stop_condition_value=0.1)
    steps = 120
    ref = jax.jit(jax.vmap(lambda s: j_rollout(
        jb, sim, env, num_steps=steps, dt=dt, state=s)))(state)
    body = convert.body_from_numpy(_np(jb))
    out, outs = fr.fused_rollout(
        convert.state_from_numpy(_np(state)), body,
        convert.sim_params_from_jax(sim), convert.env_params_from_jax(env),
        steps, float(dt))
    fit = fr.locomotion_fitness(out, body, outs)
    np.testing.assert_allclose(outs.ini_cm.numpy(), np.asarray(ref.ini_cm),
                               rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(
        fit.numpy(), np.asarray(jnp.where(ref.diverged, 0.0, ref.final_dist)),
        rtol=5e-3, atol=1e-5)


def test_stop_time_freezes_each_robot():
    jb, sim, env, dt, state = _jax_setup(2, 4, 1)
    args, kw = _packed_call_args(jb, sim, env, dt, state)
    state_p, body_p, stats = args
    stats[1, fr._S_STOP] = float(dt) * 3.5
    out, st = fr.fused_call(state_p, body_p, stats, num_steps=10, **kw)
    np.testing.assert_allclose(st[:, fr._S_TIME].numpy(),
                               [10 * float(dt), 4 * float(dt)], rtol=1e-5)
    short, _ = fr.fused_call(state_p, body_p, stats, num_steps=4, **kw)
    assert torch.equal(out[1], short[1])


def test_pair_contact_plain_matches_jax():
    rng = np.random.default_rng(7)
    V = 64
    p = (rng.uniform(0, 0.03, size=(3, V))).astype(np.float32)
    s = np.full((V,), 0.01, np.float32)
    a1 = rng.uniform(1e4, 5e4, size=(V, V)).astype(np.float32)
    a1 = np.where(rng.uniform(size=(V, V)) < 0.3, a1, 0.0).astype(np.float32)
    ref = jfr._pair_contact_forces(
        tuple(jnp.asarray(p[c:c + 1]) for c in range(3)), jnp.asarray(s[None]),
        jnp.asarray(a1), jnp.float32)
    ref = np.concatenate([np.asarray(r) for r in ref], 0)
    out = fr.pair_contact_forces(torch.as_tensor(p[None]), torch.as_tensor(s[None]),
                                 torch.as_tensor(a1[None]))[0].numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("flag", ("volume", "nonlinear", "mdl_data", "plasticity",
                                  "equilibrium", "max_vel", "bc", "collision_compact"))
def test_fused_call_refuses_flags_outside_envelope(flag, monkeypatch):
    """The material instance's options, volume effects among them, run in
    every variant: the envelope admits each in water and with development.
    What stays outside it raises by name before anything runs: ballistic
    development in water, and a fixed temperature on land, with the option
    on."""
    jb, sim, env, dt, state = _jax_setup(1, 3, 0)
    args, kw = _packed_call_args(jb, sim, env, dt, state)
    kw["flags"][flag] = True
    assert flag in fr._K1_MAT_FLAGS
    for other in (dict(fluid=True), dict(use_final_size=True), dict(fluid=True, fluid_mesh=True)):
        fr.check_envelope(dict(kw["flags"], **other), kw["scalars"])

    def must_not_run(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(fr, "fused_rollout_plain", must_not_run)
    ballistic = dict(kw, flags=dict(kw["flags"], fluid=True, use_final_size=True,
                                    ballistic=True, window=True, n_win=4),
                     scalars=dict(kw["scalars"], tb=0.01))
    with pytest.raises(NotImplementedError, match="ballistic"):
        fr.fused_call(*args, num_steps=1, **ballistic)
    fixed = dict(kw, flags=dict(kw["flags"], temp=False, temp_enabled=True))
    with pytest.raises(NotImplementedError, match="fixed"):
        fr.fused_call(*args, num_steps=1, **fixed)


def test_cuda_requests_raise_without_a_card(monkeypatch):
    """No fallback: asking for the card where there is none raises, and
    neither plain version runs."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    monkeypatch.setattr(fr, "fused_rollout_plain", None)
    monkeypatch.setattr(fr, "pair_contact_forces_plain", None)
    from evosoro_tpu_torch.evo import evaluation

    jb, sim, env, dt, state = _jax_setup(1, 3, 0)
    with pytest.raises((RuntimeError, AssertionError)):
        fr.fused_rollout(convert.state_from_numpy(_np(state), device="cuda"),
                         convert.body_from_numpy(_np(jb), device="cuda"),
                         convert.sim_params_from_jax(sim),
                         convert.env_params_from_jax(env), 1, float(dt))
    palette = evaluation.palette_from_list(evaluation.evosoro_default_palette())
    fn = evaluation.make_fused_evaluator(
        palette, (3, 3, 3), 4, (), 0.01, convert.sim_params_from_jax(sim),
        convert.env_params_from_jax(env), device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        fn(np.full((1, 3, 3, 3), 3, np.int32), {}, [convert.env_params_from_jax(env)], 0.01)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library("fused_rollout")


@pytest.mark.parametrize("case", ["ballistic_in_water", "four_sources", "window_13",
                                  "window_flag_without_slots", "no_time_between_traces"])
def test_feature_envelope_rules(case):
    """What the feature instance does not take raises by name before
    anything runs: ballistic development outside the land development
    variant, more than 3 sources, more than 12 window slots, a window flag
    that disagrees with its slot count, trace features without a time
    between traces."""
    flags = dict(temp=True, temp_enabled=True)
    scalars = dict(tb=0.01, sources=())
    err = ValueError
    if case == "ballistic_in_water":
        flags.update(fluid=True, use_final_size=True, ballistic=True, window=True, n_win=4)
        err = NotImplementedError
    elif case == "four_sources":
        scalars["sources"] = ((0.0,) * 9,) * 4
        err = NotImplementedError
    elif case == "window_13":
        flags.update(window=True, n_win=13)
    elif case == "window_flag_without_slots":
        flags.update(window=True, n_win=0)
    else:
        flags.update(ndbv=True)
        scalars["tb"] = 0.0
    with pytest.raises(err):
        fr.check_envelope(flags, scalars)


def test_shared_memory_ceiling_counts_the_static_part():
    """K1's dynamic shared memory gets what its static part (reduction
    scratch, divergence flags, the feature instance's window ring: 208
    bytes by ptxas's count) leaves of a block's 232448: 1339 cells with
    contact (39 floats a cell and the dense pair pass's staging and
    tables), 1612 without (36); one more cell each is refused on the
    host."""
    assert fr.k1_fits(1339, True) and not fr.k1_fits(1340, True)
    assert fr.k1_fits(1612, False) and not fr.k1_fits(1613, False)
    assert fr.k1_fits(11 ** 3, True)  # the largest body a card reading exists for
