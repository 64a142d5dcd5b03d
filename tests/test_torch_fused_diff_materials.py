"""The port's gradient MPC on a bilinear palette with the max-velocity clamp
held against the JAX package's kernels: `DiffRollout` and `fused_bwd_call`
on one configuration (a random 3^3 design on `bench.bilinear_palette`, 8
robots, 12 steps in 3 segments, 3 knots, the clamp at 1e-3 lattice units a
step, without floor and gravity, as the gradient-MPC benchmark runs); the
fused SQP solve on it; and the refusals that stay.

On the CPU the port runs its plain versions (the eager step, torch autograd
through it); the JAX package runs its Pallas kernels in interpret mode. The
JAX side of this configuration is stored in `fixtures/b4_materials_jax.npz`,
written by `fixtures/make_b4_materials_jax.py` from the inputs
`materials_case` builds here: JAX's forward and backward kernels with the
nonlinear stress and the clamp take 98 s to compile and run in interpret
mode on this repository's 8-core test host, more than this slice's tests may
add. The fixture holds the JAX kernels' outputs and the packed inputs they
were given (body, stats rows, dt, kernel scalars, start state); the tests
rebuild the design from the same seed, check that the port packs it into
those same inputs, and hold the port's outputs to the stored ones. The
fixture also stores `jax.grad` through JAX's jnp rollout on the case, which
the port's gradient is held to: JAX's kernel parts from it here (test (a)).
Regenerate the fixture whenever `materials_case` or either package's
kernels or packing change.

Every comparison also counts the branches the port's plain version took:
muscle bonds past their yield strain and voxels the clamp scaled back, so
that both derivatives weigh in what is compared.

Tolerances, those of tests/test_torch_fused_diff.py (the float32 states of
the two packages part in the last bits, XLA contracting multiply-adds on
the CPU): segment CoMs at atol 2e-6 m, the gradient at rtol 5e-3 / atol
5e-4 of its largest entry, the raw cotangents per channel group at rtol
5e-3 / atol 2e-3 of the group's largest JAX value over occupied voxels and
existing bonds.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evosoro_tpu.core.types as jt
from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.control import SQPConfig, sqp_optimize_fused
from evosoro_tpu_torch.core.rollout import init_state
from evosoro_tpu_torch.ops import fused_rollout as fr
from evosoro_tpu_torch.ops.fused_diff import DiffRollout
from test_torch_b4_host import branch_counts

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "b4_materials_jax.npz")
B, N, STEPS, K, N_SEGS = 8, 3, 12, 3, 3
C_S_CARRIED = fr._TSAVG  # the channels the rollout carries (and B4 pulls back)
MAX_VEL = 1e-3  # bench.MATERIALS_MAX_VEL
GROUPS = dict(pos=(0, 3), quat=(3, 7), linmom=(7, 10), angmom=(10, 13),
              scale=(13, 14), last_pos2=(17, 26), last_angle1=(26, 35),
              last_angle2=(35, 44), max_strain=(44, 47))


def j_bilinear_palette():
    """`bench.bilinear_palette` in the JAX package's types: the default
    palette with the muscles (3, 4) bilinear, yielding at 2 % strain to a
    tenth of their stiffness."""
    mats = list(jt.evosoro_default_palette())
    for k in (2, 3):
        m = mats[k]
        mats[k] = jt.Material(m.id, m.name, m.elastic_mod, cte=m.cte, rgba=m.rgba,
                              mat_model=jt.MDL_BILINEAR, yield_stress=0.02 * m.elastic_mod,
                              plastic_mod=0.1 * m.elastic_mod)
    return mats


def perturbed(state, body, L):
    """A packed (B, C_S, V) state with each occupied voxel displaced by
    0.3 L, turned by a random rotation and its momenta perturbed (as
    tests/test_torch_b4_host.py's `large_angles` case), from
    `default_rng(5)`: every voxel's quaternion lies far from the identity,
    where the step's quaternion snap (w >= 1) cannot fire."""
    rng = np.random.default_rng(5)
    st = np.array(state[..., :body.shape[-1]], dtype=np.float32)
    occ = (np.asarray(body)[:, fr._B_OCC] > 0.5).astype(np.float32)[:, None]

    def noise(c):
        return rng.standard_normal((st.shape[0], c, st.shape[2])).astype(np.float32) * occ

    q = st[:, 3:7] + noise(4) * 0.9
    norm = np.linalg.norm(q, axis=1, keepdims=True)
    st[:, 3:7] = np.where(occ > 0, q / np.where(norm > 0, norm, 1.0), st[:, 3:7])
    st[:, 0:3] += noise(3) * 0.3 * float(L)
    for a, b in ((fr._LIN, fr._LIN + 3), (fr._ANG, fr._ANG + 3)):
        st[:, a:b] += noise(3) * 0.9 * np.abs(st[:, a:b]).max()
    out = np.array(state)
    out[..., :st.shape[2]] = st
    return out


def materials_case(dtype=jnp.float32):
    """(JAX body, sim, env, dt, controls (K, 3, 3, 3)) of the configuration:
    a random 3^3 design with a muscle column on the bilinear palette, the
    clamp on, no floor and no gravity."""
    rng = np.random.default_rng(17)
    structure = rng.integers(0, 5, size=(N, N, N)).astype(np.int32)
    structure[N // 2, N // 2, :] = 3
    phase = rng.uniform(-1, 1, size=(N, N, N))
    jb = j_build_body(structure, j_palette(j_bilinear_palette()), phase_offset=phase,
                      dtype=dtype)
    sim = jt.SimParams(init_cm_time=0.0, max_velocity_enabled=True, max_vox_vel_limit=MAX_VEL)
    env = jt.EnvParams(gravity_enabled=False, floor_enabled=False)
    dt = float(j_calc_max_dt(jb)) * float(sim.dt_frac)
    u0 = rng.uniform(-0.05, 0.05, size=(K,) + jb.occ.shape).astype(np.float32)
    return jb, sim, env, dt, u0


@pytest.fixture(scope="module")
def case():
    jb, sim, env, dt, u0 = materials_case()
    ref = dict(np.load(FIXTURE))
    np.testing.assert_array_equal(ref["u0"], u0)  # the fixture's inputs are these
    body = convert.body_from_numpy(jax.tree_util.tree_map(np.asarray, jb))
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)
    assert not body.all_linear and psim.max_velocity_enabled
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


def test_diff_rollout_on_materials_matches_jax_kernels(case):
    """(a) d(final CoM-y)/d(control knots) and the segment CoMs: the port's
    `DiffRollout` (its `autograd.Function` over `fused_bwd_call`) against
    the JAX package's: the CoMs against its `DiffRollout(interpret=True)`,
    the gradient against `jax.grad` through its jnp rollout, with muscle
    bonds past yield and clamped voxels in the rollout. The JAX kernel's
    own gradient parts from its jnp BPTT on this case by 0.79 % of the
    gradient's scale, outside tests/test_fused_diff.py's bound of 0.05 %
    (ROADMAP.md section C); the port's plain version agrees with the jnp
    BPTT to 7e-7 of it."""
    body, psim, penv, dt, u0, ref = case
    dr = DiffRollout(body, psim, penv, num_steps=STEPS, num_knots=K, dt=dt, batch=B,
                     n_segs=N_SEGS)
    assert dr._kw["flags"]["nonlinear"] and dr._kw["flags"]["max_vel"]
    V = body.occ.numel()
    sp = torch.as_tensor(ref["start"][:, :, :V]).contiguous()
    u = torch.as_tensor(u0).requires_grad_(True)

    def grad():
        cms, _, _ = dr(sp, dr.stats0,
                       dr.pack_controls(u[None].expand((B,) + u.shape)).contiguous())
        return cms, torch.autograd.grad(cms[-1, 0], u)[0]

    (cms, g_p), yielded, clamped = branch_counts(grad)
    assert yielded > 0 and clamped > 0
    np.testing.assert_allclose(cms.detach().numpy(), ref["cms"], rtol=0, atol=2e-6)
    gj = ref["grad_jnp"]
    scale = np.abs(gj).max()
    assert scale > 0
    np.testing.assert_allclose(g_p.numpy(), gj, rtol=5e-3, atol=5e-4 * scale)


def test_fused_bwd_call_on_materials_matches_jax_kernel(case):
    """(b) `fused_bwd_call` with a random cotangent on the 47 carried
    channels against the JAX backward kernel (`_fused_bwd_call` through the
    segment's custom vjp) on the same packed inputs, per channel group: from
    the state the JAX segment reaches 4 steps in under random controls, each
    voxel then turned away from the identity with its momenta perturbed
    (`perturbed`), seg_base 4. Near the identity the comparison is
    ill-posed in float32: the quaternion snap (w >= 1) is decided by the
    last bit, which XLA's contraction of multiply-adds and eager torch round
    differently, and the snap cuts the cotangent. On this design 4 steps in
    without the turn, the two packages part by up to 26 % of a group's
    largest value with a linear palette and no clamp as well (measured on
    the CPU); turned, by 3e-6."""
    body, psim, penv, dt, _, ref = case
    dr = DiffRollout(body, psim, penv, num_steps=STEPS, num_knots=K, dt=dt, batch=B,
                     n_segs=N_SEGS)
    V = body.occ.numel()

    def t(name):
        return torch.as_tensor(ref[name][..., :V]).contiguous()

    (p_cs, p_cu), yielded, clamped = branch_counts(lambda: fr.fused_bwd_call(
        t("bwd_state"), dr.body_packed, torch.as_tensor(ref["bwd_stats"]).contiguous(),
        t("bwd_ctrl"), int(ref["bwd_seg_base"]), t("bwd_cot"), **dr._kw))
    assert yielded > 0 and clamped > 0
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


def test_sqp_optimize_fused_on_materials(case):
    """One Gauss-Newton iteration of `sqp_optimize_fused` on the case (the
    plain versions on the CPU): finite costs, the step accepted and the
    tracking cost lowered, controls in the box."""
    body, psim, penv, dt, _, _ = case
    cfg = SQPConfig(num_iters=1, w_reg=1e-2)
    u, info = sqp_optimize_fused(body, psim, penv, 8, 2, target=0.05, config=cfg, dt=dt,
                                 n_res=4, device="cpu")
    costs = info["cost_trace"].tolist() + [float(info["final_cost"])]
    assert np.isfinite(costs).all() and costs[-1] < costs[0], costs
    assert info["accepted_trace"].tolist() == [True]
    assert float(u.abs().max()) <= cfg.u_clip + 1e-7


def test_refusals_that_stay(case):
    """MDL_DATA materials, plasticity, equilibrium mode and BC regions stay
    outside B4's envelope: `fused_bwd_call` raises NotImplementedError naming
    each, and `DiffRollout` refuses an MDL_DATA body and a body with a BC
    region by name (the JAX `DiffRollout` sets both flags off and runs
    them). Nonlinear materials and the clamp in water and with development
    are inside the envelope (B4's material instance of each variant);
    ballistic development in water stays outside, by name."""
    from evosoro_tpu_torch.core import build_body, palette_from_list
    from evosoro_tpu_torch.core.types import (
        DOF_ALL,
        MDL_DATA,
        Material,
        evosoro_default_palette,
    )

    body, psim, penv, dt, _, _ = case
    dr = DiffRollout(body, psim, penv, num_steps=STEPS, num_knots=K, dt=dt, batch=B,
                     n_segs=N_SEGS)
    V = body.occ.numel()
    sp = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
    args = (sp, dr.body_packed, dr.stats0, torch.zeros((B, K, V)), 0,
            torch.zeros((B, fr.C_S, V)))
    for flag in ("mdl_data", "plasticity", "equilibrium", "bc"):
        kw = dict(dr._kw, flags=dict(dr._kw["flags"], **{flag: True}))
        with pytest.raises(NotImplementedError, match=f"'{flag}'"):
            fr.fused_bwd_call(*args, **kw)
    for extra in (dict(fluid=True), dict(fluid=True, fluid_mesh=True),
                  dict(use_final_size=True)):
        kw = dict(dr._kw, flags=dict(dr._kw["flags"], **extra))
        assert fr.diff_envelope_ok(kw["flags"], kw["scalars"])
        fr._check_bwd(kw["flags"], kw["scalars"], K, 0, kw["total_steps"])
    kw = dict(dr._kw, flags=dict(dr._kw["flags"], fluid=True, use_final_size=True,
                                 ballistic=True))
    with pytest.raises(NotImplementedError, match="'ballistic'"):
        fr.fused_bwd_call(*args, **kw)
    # an MDL_DATA tissue, and a pinned face
    tissue = Material(1, "tissue", mat_model=MDL_DATA, ss_strain=(0.0, 0.01, 0.05),
                      ss_stress=(0.0, 5e4, 1.6e5))
    pal = [tissue] + list(evosoro_default_palette())[1:]
    mdl = build_body(np.full((N, N, N), 1, np.int32), palette_from_list(pal), device="cpu")
    with pytest.raises(ValueError, match="'mdl_data'"):
        DiffRollout(mdl, psim, penv, num_steps=STEPS, num_knots=K, dt=dt, batch=B)
    dof = np.zeros((N, N, N), np.int32)
    dof[0] = DOF_ALL
    pinned = build_body(np.full((N, N, N), 3, np.int32),
                        palette_from_list(evosoro_default_palette()), device="cpu",
                        dof_fixed=dof)
    with pytest.raises(ValueError, match="'bc'"):
        DiffRollout(pinned, psim, penv, num_steps=STEPS, num_knots=K, dt=dt, batch=B)
