"""The port's SQP shooting (`evosoro_tpu_torch.control.sqp`): the
counterparts of tests/test_sqp.py, and the pieces of a Gauss-Newton
iteration held against the JAX package on the same inputs.

Whole solves are compared by their properties, as the JAX tests do. The
pieces by their numbers: the forward-mode product Jv of the eager residual
against `jax.jvp` in float64 (1e-9 of its largest entry; measured 1.4e-14),
the Woodbury step against a dense solve of the same normal equations in
float64 (1e-9), and one `FusedSQPSolver` iteration against the JAX solver
(its kernels in interpret mode, stored in `fixtures/sqp_iteration_jax.npz`)
in float32: the costs at rtol 1e-5, the
step `u` at 5e-3 of its largest entry, the bound
tests/test_fused_diff.py gives the Jacobian it is solved from.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.control import sqp as j_sqp
from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.control import (
    FusedSQPSolver,
    SQPConfig,
    grad_optimize,
    locomotion_sqp,
    sqp_optimize,
    sqp_optimize_fused,
    sqp_optimize_multistart,
)
from evosoro_tpu_torch.control import sqp as p_sqp
from evosoro_tpu_torch.core import EnvParams, SimParams, init_state

torch.set_num_threads(1)


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _tiny(dtype=jnp.float64):
    """tests/test_sqp.py `_tiny_body`, in both packages."""
    rng = np.random.default_rng(0)
    structure = np.full((3, 3, 2), 3, dtype=np.int32)
    phase = rng.uniform(-1, 1, size=(3, 3, 2))
    jb = j_build_body(structure, j_palette(j_default_palette()),
                      phase_offset=phase, dtype=dtype)
    tdtype = torch.float64 if dtype == jnp.float64 else torch.float32
    return jb, convert.body_from_numpy(_np(jb), dtype=tdtype)


def _check_solve(u, info, cfg, shape):
    costs = info["cost_trace"].numpy()
    assert np.isfinite(costs).all()
    # the damped-Newton loop must find at least one cost-reducing step
    assert bool(info["accepted_trace"].any())
    assert float(info["best_cost"]) <= float(costs[0])
    assert float(u.abs().max()) <= cfg.u_clip + 1e-12
    assert tuple(u.shape) == shape


def test_sqp_reduces_tracking_cost():
    _, body = _tiny()
    sim = SimParams(init_cm_time=0.0005)
    dt = float(j_calc_max_dt(_tiny()[0])) * sim.dt_frac
    cfg = SQPConfig(num_iters=2, cg_iters=2, n_res=4, w_reg=1e-2)
    u, info = sqp_optimize(body, sim, EnvParams(), 16, 3, target=0.05, config=cfg,
                           dt=dt, device="cpu")
    _check_solve(u, info, cfg, (3, 3, 3, 2))


def test_sqp_zero_target_prefers_zero_control():
    _, body = _tiny()
    sim = SimParams(init_cm_time=0.0005)
    dt = float(j_calc_max_dt(_tiny()[0])) * sim.dt_frac
    cfg = SQPConfig(num_iters=2, cg_iters=2, n_res=4, w_reg=1.0)
    u, _ = sqp_optimize(body, sim, EnvParams(temp_enabled=False), 16, 2, target=0.0,
                        config=cfg, dt=dt, device="cpu")
    assert float(u.abs().max()) < 0.05


def test_sqp_fused_reduces_tracking_cost():
    jb, body = _tiny(jnp.float32)
    sim = SimParams(init_cm_time=0.0)
    dt = float(j_calc_max_dt(jb)) * sim.dt_frac
    cfg = SQPConfig(num_iters=1, w_reg=1e-2)
    u, info = sqp_optimize_fused(body, sim, EnvParams(), 8, 2, target=0.05,
                                 config=cfg, dt=dt, n_res=4, device="cpu")
    _check_solve(u, info, cfg, (2, 3, 3, 2))


SQP_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                           "sqp_iteration_jax.npz")


def sqp_iteration_case():
    """(JAX body, port body, dt, steps, knots, n_res, config, start controls)
    of the one-iteration comparison: `_tiny` in float32, 8 steps, 2 knots, 4
    residual points, from a random non-zero start."""
    jb, body = _tiny(jnp.float32)
    dt = float(j_calc_max_dt(jb)) * 0.9
    u0 = np.random.default_rng(1).uniform(-0.02, 0.02, size=(2, 3, 3, 2)).astype(np.float32)
    return jb, body, dt, 8, 2, 4, dict(num_iters=1, w_reg=1e-2), u0


def test_fused_iteration_matches_jax_solver():
    """One Gauss-Newton iteration of `FusedSQPSolver` from a non-zero start
    against the JAX solver's (Pallas kernels in interpret mode): the cost
    before and after the step, the accept decision and the step itself. The
    JAX solve is stored in `fixtures/sqp_iteration_jax.npz` (written by
    `fixtures/make_sqp_iteration_jax.py`; its compile in interpret mode took
    minutes), beside the inputs its kernels were given, which the port must
    pack from the same design (rtol 1e-6: the last bits of a host's float32
    arithmetic)."""
    _, body, dt, steps, K, n_res, cfg, u0 = sqp_iteration_case()
    ref = dict(np.load(SQP_FIXTURE))
    np.testing.assert_array_equal(ref["u0"], u0)
    np.testing.assert_allclose(dt, float(ref["dt"]), rtol=1e-12)
    solver = FusedSQPSolver(body, SimParams(init_cm_time=0.0), EnvParams(), steps, K,
                            config=SQPConfig(**cfg), dt=dt, n_res=n_res, device="cpu")
    dr = solver._dr
    np.testing.assert_allclose(dr.body_packed.numpy(), ref["body"], rtol=1e-6, atol=0)
    # the port's batch is n_res rows, JAX's n_res padded to 8: the rows agree
    n = dr.stats0.shape[0]
    np.testing.assert_allclose(dr.stats0.numpy(), ref["stats0"][:n], rtol=1e-6, atol=0)
    occ = body.occ.reshape(-1).numpy()
    np.testing.assert_allclose(solver._sp0.numpy()[:, :, occ], ref["start"][:n, :, occ],
                               rtol=1e-6, atol=0)
    u, info = solver.solve(target=0.05, init_u=torch.as_tensor(u0))
    np.testing.assert_allclose(info["cost_trace"].numpy(), ref["cost_trace"], rtol=1e-5)
    # after the step: the steps agree to 5e-3 of their size (below)
    np.testing.assert_allclose(float(info["final_cost"]), float(ref["final_cost"]),
                               rtol=5e-4)
    assert info["accepted_trace"].tolist() == ref["accepted_trace"].tolist()
    assert bool(info["accepted_trace"][0])
    step_j = ref["u"] - u0
    assert np.abs(step_j).max() > 0
    np.testing.assert_allclose(u.numpy() - u0, step_j, rtol=0,
                               atol=5e-3 * np.abs(step_j).max())


def test_eager_residual_jvp_matches_jax_jvp():
    """`sqp_optimize`'s Jv is a forward-mode product through the eager
    rollout: `torch.func.jvp` of the residual against `jax.jvp`, float64,
    floor and gravity on."""
    jb, body = _tiny()
    jsim, jenv = JSim(init_cm_time=0.0005), JEnv()
    dt = float(j_calc_max_dt(jb)) * 0.9
    steps, K = 8, 3
    rng = np.random.default_rng(2)
    u0 = rng.uniform(-0.03, 0.03, size=(K, 3, 3, 2))
    v0 = rng.standard_normal((K, 3, 3, 2))
    jcfg, cfg = j_sqp.SQPConfig(n_res=4), SQPConfig(n_res=4)
    jstate = j_init_state(jb, dtype=jnp.float64)
    r_j, jv_j = jax.jvp(
        lambda u: j_sqp._tracking_residual(u, jb, jsim, jenv, steps, dt, jstate, 0.05, jcfg),
        (jnp.asarray(u0),), (jnp.asarray(v0),))
    state = init_state(body)
    r_p, jv_p = torch.func.jvp(
        lambda u: p_sqp._tracking_residual(
            u, body, convert.sim_params_from_jax(jsim), convert.env_params_from_jax(jenv),
            steps, dt, state, 0.05, cfg),
        (torch.as_tensor(u0),), (torch.as_tensor(v0),))
    assert r_p.dtype == torch.float64
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(r_j)).max())
    np.testing.assert_allclose(jv_p.numpy(), np.asarray(jv_j), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(jv_j)).max())


def test_woodbury_step_solves_the_damped_normal_equations():
    rng = np.random.default_rng(3)
    n_res, P = 5, 40
    jt = torch.as_tensor(rng.standard_normal((n_res, P)))
    r = torch.as_tensor(rng.standard_normal(n_res))
    u = torch.as_tensor(rng.standard_normal(P))
    lam, w2 = torch.tensor(0.3, dtype=torch.float64), 0.05
    delta = p_sqp.woodbury_step(jt, r, u, lam, w2)
    dense = torch.linalg.solve(jt.T @ jt + (lam + w2) * torch.eye(P, dtype=torch.float64),
                               -(jt.T @ r + w2 * u))
    np.testing.assert_allclose(delta.numpy(), dense.numpy(), rtol=1e-9, atol=1e-12)


def test_cg_solves_an_spd_system():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, 6))
    a = torch.as_tensor(a @ a.T + 6 * np.eye(6))
    b = torch.as_tensor(rng.standard_normal(6))
    x = p_sqp._cg(lambda v: a @ v, b, 6)
    np.testing.assert_allclose((a @ x).numpy(), b.numpy(), rtol=1e-8, atol=1e-10)
    assert bool((p_sqp._cg(lambda v: a @ v, torch.zeros(6, dtype=torch.float64), 3) == 0).all())


def test_multistart_and_pipeline_run_and_mesh_raises():
    _, body = _tiny()
    sim = SimParams(init_cm_time=0.0005)
    dt = float(j_calc_max_dt(_tiny()[0])) * sim.dt_frac
    cfg = SQPConfig(num_iters=1, cg_iters=1, n_res=2, w_reg=1e-2)
    gen = torch.Generator().manual_seed(0)
    u, info = sqp_optimize_multistart(gen, body, sim, EnvParams(), 8, 2, n_starts=2,
                                      target=0.05, config=cfg, dt=dt, device="cpu")
    assert tuple(u.shape) == (2, 3, 3, 2) and info["all_costs"].shape == (2,)
    assert float(info["best_cost"]) == float(info["all_costs"].min())
    # an object that is not a mesh is refused by name
    with pytest.raises(TypeError, match="mesh must be .* not object"):
        sqp_optimize_multistart(gen, body, sim, EnvParams(), 8, 2, mesh=object(),
                                device="cpu")
    with pytest.raises(TypeError):
        sqp_optimize_multistart(None, body, sim, EnvParams(), 8, 2, device="cpu")
    u, info = locomotion_sqp(body, sim, EnvParams(), 8, 2, target_dist=0.05,
                             warm_start_cem=False, sqp_config=cfg, dt=dt, device="cpu")
    assert info["cem"] is None and bool(torch.isfinite(info["cost_trace"]).all())


@pytest.mark.parametrize("entry", ["sqp_optimize", "sqp_optimize_fused",
                                   "FusedSQPSolver", "sqp_optimize_multistart",
                                   "locomotion_sqp", "grad_optimize"])
def test_gradient_entry_points_need_the_card_unless_cpu_is_asked(entry):
    """No device argument means the card: without one the entry points raise
    (and say how to ask for the CPU) before any rollout runs."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    _, body = _tiny(jnp.float32)
    sim, env = SimParams(init_cm_time=0.0), EnvParams()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == "sqp_optimize":
            sqp_optimize(body, sim, env, 4, 2)
        elif entry == "sqp_optimize_fused":
            sqp_optimize_fused(body, sim, env, 4, 2)
        elif entry == "FusedSQPSolver":
            FusedSQPSolver(body, sim, env, 4, 2)
        elif entry == "sqp_optimize_multistart":
            sqp_optimize_multistart(torch.Generator(), body, sim, env, 4, 2)
        elif entry == "locomotion_sqp":
            locomotion_sqp(body, sim, env, 4, 2, 0.05)
        else:
            grad_optimize(body, sim, env, 4, 2)
