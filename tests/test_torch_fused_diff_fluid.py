"""The port's gradient MPC in water held against the JAX package's kernels:
`DiffRollout`, `fused_bwd_call` and `sqp_optimize_fused` with the facet
drag on the deformed surface mesh, on one configuration (a 3^3 design in
its 4^3 shell, 8 robots, 8 steps in 2 segments, 2 knots); and the eager
gradient-MPC entry points run in water on the same design.

On the CPU the port runs its plain versions (the eager step, torch autograd
through it); the JAX package runs its Pallas kernels in interpret mode. The
JAX side of this configuration is stored in `fixtures/b4_water_jax.npz`,
written by `fixtures/make_b4_water_jax.py` from the inputs `water_case`
builds here: compiling the JAX backward kernel with the facet drag in
interpret mode takes 174 s on this repository's 8-core test host (the
forward kernel 20 s, the fused SQP solve's program 300 s), three times the
time the whole of this slice's tests may add. The fixture holds the JAX
kernels' outputs and the packed inputs they were given (body, stats rows,
dt, kernel scalars, start state); the tests rebuild the design from the
same seed, check that the port packs it into those same inputs, and hold
the port's outputs to the stored ones. Regenerate the fixture whenever
`water_case` or the JAX package's kernels change.

Tolerances, those of tests/test_torch_fused_diff.py (the float32 states of
the two packages part in the last bits, XLA contracting multiply-adds on
the CPU): segment CoMs at atol 2e-6 m, the gradient at rtol 5e-3 / atol
5e-4 of its largest entry, the raw cotangents per channel group at rtol
5e-3 / atol 2e-3 of the group's largest JAX value over occupied voxels and
existing bonds, the SQP costs at rtol 5e-3.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu.envs.drag import attach_mesh_drag as j_attach_mesh_drag
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.control import SQPConfig, sqp_optimize_fused
from evosoro_tpu_torch.core.rollout import init_state
from evosoro_tpu_torch.ops import fused_rollout as fr
from evosoro_tpu_torch.ops.fused_diff import DiffRollout

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "b4_water_jax.npz")
B, N, STEPS, K, N_SEGS = 8, 3, 8, 2, 2
C_S_CARRIED = fr._TSAVG  # the channels the rollout carries (and B4 pulls back)
SQP = dict(steps=8, knots=2, n_res=4, target=0.05, cfg=dict(num_iters=1, w_reg=1e-2))
# water at 200 x the swimming experiment's drag coefficient: the drag's
# derivative weighs in a few steps
WATER = dict(fluid_environment=True, gravity_enabled=False, floor_enabled=False,
             aggregate_drag_coefficient=1.5e5)
GROUPS = dict(pos=(0, 3), quat=(3, 7), linmom=(7, 10), angmom=(10, 13),
              scale=(13, 14), last_pos2=(17, 26), last_angle1=(26, 35),
              last_angle2=(35, 44), max_strain=(44, 47))


def water_case():
    """(JAX body, sim, env, dt, controls (K, 4, 4, 4)) of the configuration:
    a random 3^3 design with a muscle column, in its +X/+Y/+Z shell, with
    the JAX package's mesh tables."""
    rng = np.random.default_rng(13)
    structure = rng.integers(0, 5, size=(N, N, N)).astype(np.int32)
    structure[N // 2, N // 2, :] = 3
    phase = rng.uniform(-1, 1, size=(N, N, N))
    shell = ((0, 1),) * 3
    jb = j_attach_mesh_drag(j_build_body(np.pad(structure, shell),
                                         j_palette(j_default_palette()),
                                         phase_offset=np.pad(phase, shell),
                                         dtype=jnp.float32))
    sim, env = JSim(init_cm_time=0.0), JEnv(**WATER)
    dt = float(j_calc_max_dt(jb)) * float(sim.dt_frac)
    u0 = rng.uniform(-0.1, 0.1, size=(K,) + jb.occ.shape).astype(np.float32)
    return jb, sim, env, dt, u0


@pytest.fixture(scope="module")
def case():
    jb, sim, env, dt, u0 = water_case()
    ref = dict(np.load(FIXTURE))
    np.testing.assert_array_equal(ref["u0"], u0)  # the fixture's inputs are these
    body = convert.body_from_numpy(jax.tree_util.tree_map(np.asarray, jb))
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)
    assert body.mesh_drag is not None and fr.has_corner_shell(body.occ)
    # the inputs the JAX kernels were given are the ones the port packs from
    # this design (rtol 1e-6: the last bits of a host's float32 arithmetic)
    np.testing.assert_allclose(dt, float(ref["dt"]), rtol=1e-12)
    np.testing.assert_allclose(fr.pack_body(body).numpy(), ref["body"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(fr.make_stats(body, B, dt, psim, penv).numpy(), ref["stats0"],
                               rtol=1e-6, atol=0)
    scalars = fr.kernel_scalars(body.nominal_size, psim, penv)
    assert json.loads(json.dumps(scalars, sort_keys=True)) == json.loads(str(ref["scalars"]))
    start = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).numpy()
    occ = body.occ.reshape(-1).numpy() > 0
    np.testing.assert_allclose(start[:, :, occ], ref["start"][:, :, occ], rtol=1e-6, atol=0)
    return body, psim, penv, dt, u0, ref


def test_diff_rollout_in_water_matches_jax_kernels(case):
    """d(final CoM-y)/d(control knots) and the segment CoMs: the port's
    `DiffRollout` (its `autograd.Function` over `fused_bwd_call`) against
    the JAX package's `DiffRollout(interpret=True)`."""
    body, psim, penv, dt, u0, ref = case
    dr = DiffRollout(body, psim, penv, num_steps=STEPS, num_knots=K, dt=dt, batch=B,
                     n_segs=N_SEGS)
    assert dr._kw["flags"]["fluid"] and dr._kw["flags"]["fluid_mesh"]
    V = body.occ.numel()
    sp = torch.as_tensor(ref["start"][:, :, :V]).contiguous()
    u = torch.as_tensor(u0).requires_grad_(True)
    cms, _, _ = dr(sp, dr.stats0, dr.pack_controls(u[None].expand((B,) + u.shape)).contiguous())
    (g_p,) = torch.autograd.grad(cms[-1, 0], u)
    np.testing.assert_allclose(cms.detach().numpy(), ref["cms"], rtol=0, atol=2e-6)
    gj = ref["grad"]
    scale = np.abs(gj).max()
    assert scale > 0
    np.testing.assert_allclose(g_p.numpy(), gj, rtol=5e-3, atol=5e-4 * scale)


def test_fused_bwd_call_in_water_matches_jax_kernel(case):
    """`fused_bwd_call` with a random cotangent on the 47 carried channels,
    from the state the JAX segment reaches 4 steps in under random controls
    (seg_base 4), against the JAX backward kernel (`_fused_bwd_call` through
    the segment's custom vjp) on the same packed inputs."""
    body, psim, penv, dt, _, ref = case
    dr = DiffRollout(body, psim, penv, num_steps=STEPS, num_knots=K, dt=dt, batch=B,
                     n_segs=N_SEGS)
    V = body.occ.numel()

    def t(name):
        return torch.as_tensor(ref[name][..., :V]).contiguous()

    p_cs, p_cu = fr.fused_bwd_call(t("bwd_state"), dr.body_packed,
                                   torch.as_tensor(ref["bwd_stats"]).contiguous(),
                                   t("bwd_ctrl"), int(ref["bwd_seg_base"]), t("bwd_cot"),
                                   **dr._kw)
    assert bool((p_cs[:, fr._TSAVG:] == 0).all())
    occ = body.occ.reshape(-1).numpy()
    bonds = body.bond_mask.reshape(3, -1).numpy()
    j_cs = ref["bwd_cot_state"][:, :, :V]
    for name, (a, b) in GROUPS.items():
        if name in ("last_pos2", "last_angle1", "last_angle2"):
            live = np.repeat(bonds, 3, axis=0)
        elif name == "max_strain":
            live = bonds
        else:
            live = np.broadcast_to(occ, (b - a, V))
        jref, got = j_cs[:, a:b] * live, p_cs[:, a:b].numpy() * live
        np.testing.assert_allclose(got, jref, rtol=5e-3,
                                   atol=2e-3 * max(np.abs(jref).max(), 1e-30),
                                   err_msg=name)
    jref = ref["bwd_cot_ctrl"][:, :, :V]
    assert np.abs(jref).max() > 0
    np.testing.assert_allclose(p_cu.numpy(), jref, rtol=5e-3, atol=5e-4 * np.abs(jref).max())


def test_sqp_optimize_fused_in_water_matches_jax(case):
    """One Gauss-Newton iteration of `sqp_optimize_fused` in water (the
    plain versions on the CPU) against the JAX package's (its kernels in
    interpret mode) from a zero start: the costs before and after the step
    and the accept decision."""
    body, psim, penv, dt, _, ref = case
    u, info = sqp_optimize_fused(body, psim, penv, SQP["steps"], SQP["knots"],
                                 target=SQP["target"], config=SQPConfig(**SQP["cfg"]),
                                 dt=dt, n_res=SQP["n_res"], device="cpu")
    np.testing.assert_allclose(info["cost_trace"].numpy(), ref["sqp_cost_trace"], rtol=5e-3)
    np.testing.assert_allclose(float(info["final_cost"]), float(ref["sqp_final_cost"]),
                               rtol=5e-3)
    assert info["accepted_trace"].tolist() == ref["sqp_accepted"].tolist()
    assert float(ref["sqp_final_cost"]) < float(ref["sqp_cost_trace"][0])
    assert tuple(u.shape) == (SQP["knots"],) + tuple(body.occ.shape)


def test_eager_gradient_mpc_runs_in_water(case):
    """The eager gradient-MPC entry points differentiate the eager rollout
    in water too: one `sqp_optimize` iteration (forward-mode products
    through the facet drag, reverse-mode pullbacks) and two `grad_optimize`
    iterations give finite costs, and the Gauss-Newton step lowers the
    tracking cost."""
    from evosoro_tpu_torch.control import grad_optimize, sqp_optimize

    body, psim, penv, dt, _, _ = case
    cfg = SQPConfig(num_iters=1, cg_iters=2, n_res=4, w_reg=1e-2)
    u, info = sqp_optimize(body, psim, penv, 8, 2, target=0.05, config=cfg, dt=dt,
                           device="cpu")
    costs = info["cost_trace"].tolist() + [float(info["final_cost"])]
    assert np.isfinite(costs).all() and costs[-1] < costs[0], costs
    assert float(u.abs().max()) <= cfg.u_clip
    _, info = grad_optimize(body, psim, penv, 8, 2, num_iters=2, lr=1e-3, dt=dt,
                            init_u=torch.full((2,) + tuple(body.occ.shape), 0.01),
                            device="cpu")
    assert np.isfinite(info["cost_trace"].numpy()).all()
