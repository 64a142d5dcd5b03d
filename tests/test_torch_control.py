"""The port's sampling MPC (`evosoro_tpu_torch.control`): the counterparts
of tests/test_control.py and tests/test_fused_cem.py, plus one CEM update held against the JAX package's
with the same candidates and costs fed to both.

The solvers draw their noise from a `torch.Generator`, the JAX ones from a
PRNG key, so whole solves are compared by their properties (as the JAX
tests do), and the update by its numbers: there the tolerance is float32
rounding of a mean and a deviation over the elites (rtol 1e-6, atol 1e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.control import shooting as j_shooting
from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu_torch.control import (
    CEMConfig,
    CEMState,
    MPCController,
    cem_optimize,
    cem_optimize_fused,
    cem_update,
    grad_optimize,
    locomotion_cost,
    make_fused_cem_solver,
    make_fused_mpc_closed_loop,
    mpc_run,
)
from evosoro_tpu_torch.core import (
    EnvParams,
    SimParams,
    build_body,
    calc_max_dt,
    evosoro_default_palette,
    palette_from_list,
    rollout,
)
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _body(seed=3, structure=None, lo=0.0):
    rng = np.random.default_rng(seed)
    if structure is None:
        structure = rng.integers(1, 5, size=(3, 3, 2)).astype(np.int32)
    return build_body(structure, palette_from_list(evosoro_default_palette()),
                      lattice_dim=0.01,
                      phase_offset=rng.uniform(lo, 1, size=(3, 3, 2)))


def test_cem_improves_cost():
    body = _body()
    sim = SimParams(stop_condition_value=0.05, init_cm_time=0.0)
    env = EnvParams(temp_enabled=False)  # pure control, no open-loop sinusoid
    dt = float(calc_max_dt(body) * sim.dt_frac)
    steps = 30
    cfg = CEMConfig(num_iters=3, pop_size=8, init_std=0.05)
    u, info = cem_optimize(_gen(), body, sim, env, steps, 3, cfg, dt=dt, device="cpu")
    assert u.shape == (3, 3, 3, 2)
    # best cost must beat the zero-control cost
    zero = rollout(body, sim, env, num_steps=steps, dt=dt)
    assert float(info["best_cost"]) <= float(-zero.norm_final_dist) + 1e-9
    # the returned plan really has the returned cost
    again = rollout(body, sim, env, num_steps=steps, dt=dt, control_sequence=u)
    assert float(-again.norm_final_dist) == float(info["best_cost"])
    # trace is monotone non-increasing (best-so-far)
    trace = info["best_cost_trace"].numpy()
    assert trace.shape == (3,) and np.all(np.diff(trace) <= 1e-12)
    assert float(u.abs().max()) <= cfg.u_clip


def test_mpc_closed_loop():
    body = _body()
    sim = SimParams(stop_condition_value=1.0, init_cm_time=0.0)
    env = EnvParams(temp_enabled=False)
    dt = float(calc_max_dt(body) * sim.dt_frac)
    ctrl = MPCController(body=body, sim=sim, env=env, dt=dt, plan_steps=20,
                         plan_knots=2, execute_knots=1,
                         config=CEMConfig(num_iters=2, pop_size=8))
    final_state, executed, costs = mpc_run(_gen(1), ctrl, total_segments=2,
                                           device="cpu")
    assert executed.shape == (2, 3, 3, 2)
    np.testing.assert_allclose(float(final_state.time), 2 * 10 * dt, rtol=1e-5)
    assert torch.isfinite(final_state.pos).all()
    assert torch.isfinite(costs).all() and costs.shape == (2,)


def test_fused_cem_improves():
    body = _body(0, np.full((3, 3, 2), 3, dtype=np.int32), lo=-1.0)
    sim = SimParams(init_cm_time=0.001)
    env = EnvParams()
    dt = float(calc_max_dt(body) * sim.dt_frac)
    cfg = CEMConfig(num_iters=3, pop_size=8, init_std=0.05)
    u, info = cem_optimize_fused(_gen(), body, sim, env, num_steps=30, num_knots=2,
                                 config=cfg, dt=dt, device="cpu")
    trace = info["best_cost_trace"].numpy()
    assert np.isfinite(trace).all()
    assert np.all(np.diff(trace) <= 1e-12)  # best cost is monotone
    assert float(u.abs().max()) <= cfg.u_clip + 1e-7
    assert isinstance(info["best_cost"], float) and info["best_cost"] < 1e9
    assert info["final_std"].shape == u.shape == (2, 3, 3, 2)
    # the same seed gives the same solve
    u2, info2 = cem_optimize_fused(_gen(), body, sim, env, num_steps=30, num_knots=2,
                                   config=cfg, dt=dt, device="cpu")
    assert torch.equal(u, u2) and info2["best_cost"] == info["best_cost"]


def test_fused_cem_agrees_with_eager_cem():
    """Same generator, same design: the fused solve (K1's plain version on
    the CPU) and the eager solve score their candidates alike, so they walk
    the same distributions."""
    body = _body(0, np.full((3, 3, 2), 3, dtype=np.int32), lo=-1.0)
    sim, env = SimParams(init_cm_time=0.0), EnvParams()
    dt = float(calc_max_dt(body) * sim.dt_frac)
    cfg = CEMConfig(num_iters=2, pop_size=8, init_std=0.05)
    u_f, info_f = cem_optimize_fused(_gen(4), body, sim, env, 16, 2, cfg, dt=dt,
                                     device="cpu")
    u_e, info_e = cem_optimize(_gen(4), body, sim, env, 16, 2, cfg, dt=dt,
                               device="cpu")
    torch.testing.assert_close(u_f, u_e, rtol=0, atol=0)
    torch.testing.assert_close(info_f["final_mean"], info_e["final_mean"],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(info_f["best_cost"], float(info_e["best_cost"]),
                               rtol=1e-4, atol=1e-8)


def test_fused_solver_launches_once_per_iteration(monkeypatch):
    """A solve is `num_iters` calls of the rollout wrapper, each over the
    whole population, and nothing in the solver's loop reads a tensor on the
    host. (The wrapper is replaced by one that moves every candidate by its
    first control value: on the CPU the real one runs the eager step, whose
    envelope checks do read flags on the host.)"""
    body = _body(0, np.full((3, 3, 2), 3, dtype=np.int32), lo=-1.0)
    sim, env = SimParams(init_cm_time=0.0), EnvParams()
    runner = fr.FusedBatchRunner(body, sim, env, batch=8, num_steps=6, num_knots=2)
    cfg = CEMConfig(num_iters=4, pop_size=8)
    calls = []

    def counting(state, body, stats, coll, *, control_packed, **k):
        calls.append(tuple(control_packed.shape))
        out = state.clone()
        out[:, fr._POS] += control_packed[:, 0, :1]
        return out, stats

    monkeypatch.setattr(fr, "fused_call", counting)
    for name in ("item", "tolist", "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a: (_ for _ in ()).throw(
            AssertionError("the solve synchronised with the host")))
    solve = make_fused_cem_solver(runner, 2, (3, 3, 2), cfg)
    shape = (2, 3, 3, 2)
    out = solve(_gen(), (runner.state_packed, runner.body_packed, runner.stats, None),
                torch.zeros(shape), torch.full(shape, cfg.init_std))
    monkeypatch.undo()
    assert calls == [(8, 2, 18)] * 4
    best_u, best_cost, best_trace, mean_trace, mean, std = out
    assert best_trace.shape == mean_trace.shape == (4,)
    assert float(best_cost) == float(best_trace[-1])
    # an object that is not a mesh is refused by name
    with pytest.raises(TypeError, match="mesh must be .* not object"):
        make_fused_cem_solver(runner, 2, (3, 3, 2), cfg, mesh=object())


def test_fused_mpc_closed_loop():
    """make_fused_mpc_closed_loop: the executed trajectory advances sim time
    by n_segments x exec_steps x dt, planned costs stay finite, and the warm
    replans keep the loop stable (no divergence latch)."""
    body = _body(1, np.full((3, 3, 2), 3, dtype=np.int32), lo=-1.0)
    sim, env = SimParams(init_cm_time=0.0), EnvParams()
    dt = float(calc_max_dt(body) * sim.dt_frac)
    cfg = CEMConfig(num_iters=2, pop_size=8, init_std=0.05)
    run, aux = make_fused_mpc_closed_loop(body, sim, env, plan_steps=16,
                                          plan_knots=4, exec_knots=2, config=cfg,
                                          dt=dt, device="cpu")
    assert aux["state"].shape == (1, fr.C_S, 18) and aux["stats"].shape == (1, fr.C_STAT)
    assert aux["exec_steps"] == 8 and aux["P"] == 8
    n_seg = 3
    mean0 = torch.zeros(aux["shape"])
    std0 = torch.full(aux["shape"], cfg.init_std)
    start = aux["cm_xy"](aux["state"], aux["stats"])
    state, stats, costs = run(_gen(), n_seg, aux["state"], aux["stats"], mean0, std0)
    assert costs.shape == (n_seg,) and torch.isfinite(costs).all()
    # time advanced by exactly the executed horizon
    np.testing.assert_allclose(float(stats[0, fr._S_TIME]),
                               n_seg * aux["exec_steps"] * dt, rtol=1e-5)
    assert not bool((stats[:, fr._S_DIV] > 0.5).any())
    assert float(torch.linalg.norm(aux["cm_xy"](state, stats) - start)) > 0
    # the initial packed state was not written to
    assert float(aux["stats"][0, fr._S_TIME]) == 0.0


def test_cem_update_matches_jax():
    """One CEM iteration with the SAME candidates and costs in both
    packages: JAX's `cem_optimize` is run with its sampler and its rollout
    batch replaced by fixed numpy arrays, the port's `cem_update` gets the
    same. Ties in the costs make the elite order depend on the sort's
    stability, and four elites make the population and the sample deviation
    differ by a factor sqrt(4/3)."""
    rng = np.random.default_rng(5)
    K, grid, P = 3, (3, 3, 2), 16
    shape = (K,) + grid
    eps = rng.normal(size=(P,) + shape).astype(np.float32)
    init_mean = rng.uniform(-0.01, 0.01, size=shape).astype(np.float32)
    costs = np.array([3, 1, 2, 1, 5, 2, 2, 1, 4, 2, 6, 7, 8, 9, 2, 3], np.float32)
    cfg_kw = dict(num_iters=1, pop_size=P, elite_frac=0.25, init_std=0.05,
                  smoothing=0.3)

    jb = j_build_body(np.full(grid, 3, np.int32), j_palette(j_default_palette()),
                      dtype=jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shp, dtype: jnp.asarray(eps, dtype))
        mp.setattr(j_shooting, "_evaluate_batch", lambda us, *a: jnp.asarray(costs))
        best_u_j, info_j = j_shooting.cem_optimize.__wrapped__(
            jax.random.PRNGKey(0), jb, JSim(), JEnv(), 4, K,
            j_shooting.CEMConfig(**cfg_kw), dt=1e-4, init_mean=jnp.asarray(init_mean))

    cfg = CEMConfig(**cfg_kw)
    state = CEMState.initial(torch.as_tensor(init_mean),
                             torch.full(shape, cfg.init_std))
    us = torch.clamp(state.mean[None] + state.std[None] * torch.as_tensor(eps),
                     -cfg.u_clip, cfg.u_clip)
    new = cem_update(state, us, torch.as_tensor(costs), cfg)
    tol = dict(rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(new.mean.numpy(), np.asarray(info_j["final_mean"]), **tol)
    np.testing.assert_allclose(new.std.numpy(), np.asarray(info_j["final_std"]), **tol)
    np.testing.assert_allclose(new.best_u.numpy(), np.asarray(best_u_j), **tol)
    assert float(new.best_cost) == float(info_j["best_cost"]) == 1.0
    # the first of the tied best candidates, and the first four by a stable sort
    assert torch.equal(new.best_u, us[1])
    elites = us[[1, 3, 7, 2]]
    torch.testing.assert_close(
        new.std, 0.3 * (elites.std(0, correction=0) + cfg.min_std) + 0.7 * state.std)


@pytest.mark.parametrize("entry", ["cem_optimize", "cem_optimize_fused",
                                   "make_fused_mpc_closed_loop", "mpc_run"])
def test_entry_points_need_the_card_unless_cpu_is_asked(entry, monkeypatch):
    """No device argument means the card: without one the entry points raise
    (and say how to ask for the CPU) before any rollout runs."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    body = _body()
    sim, env = SimParams(init_cm_time=0.0), EnvParams()
    monkeypatch.setattr(fr, "fused_rollout_plain", None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == "cem_optimize":
            cem_optimize(_gen(), body, sim, env, 4, 2)
        elif entry == "cem_optimize_fused":
            cem_optimize_fused(_gen(), body, sim, env, 4, 2)
        elif entry == "make_fused_mpc_closed_loop":
            make_fused_mpc_closed_loop(body, sim, env, 4, 2)
        else:
            mpc_run(_gen(), MPCController(body, sim, env, 1e-4, 4, 2), 1)
    with pytest.raises(TypeError):
        cem_optimize_fused(None, body, sim, env, 4, 2, device="cpu")


def test_grad_optimize_runs_and_descends():
    """Twin of tests/test_control.py::test_grad_optimize_runs_and_descends."""
    body = _body()
    sim = SimParams(stop_condition_value=0.02, init_cm_time=0.0)
    env = EnvParams(temp_enabled=False)
    dt = calc_max_dt(body) * sim.dt_frac
    u, info = grad_optimize(body, sim, env, num_steps=25, num_knots=2,
                            num_iters=5, lr=5e-3, dt=dt, device="cpu")
    cs = info["cost_trace"].numpy()
    assert tuple(u.shape) == (2, 3, 3, 2) and not u.requires_grad
    assert np.all(np.isfinite(cs))
    assert cs[-1] <= cs[0] + 1e-9
    assert float(info["final_cost"]) == float(cs[-1])


def test_grad_optimize_first_update_is_optax_adams():
    """One `grad_optimize` iteration moves `u` by `optax.adam`'s first
    update on the same gradient (torch autograd's, handed to optax): the
    same b1, b2, eps and bias correction. Float32, rtol 1e-6."""
    import optax

    body = _body()
    sim = SimParams(stop_condition_value=0.02, init_cm_time=0.0)
    env = EnvParams(temp_enabled=False)
    dt = calc_max_dt(body) * sim.dt_frac
    u0 = np.random.default_rng(5).uniform(-0.02, 0.02, size=(2, 3, 3, 2)).astype(np.float32)
    lr = 5e-3
    u1, _ = grad_optimize(body, sim, env, num_steps=10, num_knots=2, num_iters=1,
                          lr=lr, dt=dt, init_u=u0, device="cpu")
    u = torch.as_tensor(u0).requires_grad_(True)
    cost = locomotion_cost(rollout(body, sim, env, num_steps=10, dt=dt,
                                   control_sequence=u))
    (g,) = torch.autograd.grad(cost, u)
    assert float(g.abs().max()) > 0
    opt = optax.adam(lr)
    updates, _ = opt.update(jnp.asarray(g.numpy()), opt.init(jnp.asarray(u0)))
    np.testing.assert_allclose(u1.numpy() - u0, np.asarray(updates), rtol=1e-6, atol=1e-12)
