"""The port's differentiable fused rollout (`ops/fused_diff.py`) and the
reverse-mode segment wrapper (`fused_bwd_call`) held against the JAX
package on the same inputs.

On the CPU `fused_call` and `fused_bwd_call` run their plain versions (the
eager step and torch autograd through it), so these check the host side
(the `autograd.Function`, the segment chain, the cotangent layout) and the
plain version's derivative; the CUDA kernel is held against that plain
version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py) and,
compiled for the host, in tests/test_torch_b4_host.py. The JAX kernels run
in interpret mode, as tests/test_fused_diff.py runs them.

Both packages get literally the same packed arrays: the channel maps are
identical and the JAX layout only pads the voxel axis to 128 lanes.

Tolerances. Eager BPTT in float64 (test (c)) carries the weight: the two
packages agree to 7e-14 of the gradient's scale there, held at 1e-9.
In float32 XLA contracts `a*b+c` into FMA on the CPU and eager torch does
not, so the recomputed forward states differ in the last bit; gradients
are then held at the JAX test's own bound (rtol 5e-3, atol 5e-4 of the
largest entry), per channel group for the raw cotangents.
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
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu.envs.drag import attach_mesh_drag as j_attach_mesh_drag
from evosoro_tpu.ops.fused_diff import DiffRollout as JDiffRollout
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.core import EnvParams, SimParams, rollout
from evosoro_tpu_torch.ops import fused_rollout as fr
from evosoro_tpu_torch.ops.fused_diff import DiffRollout

torch.set_num_threads(1)
jfr = importlib.import_module("evosoro_tpu.ops.fused_rollout")

B = 8
GROUPS = dict(pos=(0, 3), quat=(3, 7), linmom=(7, 10), angmom=(10, 13),
              scale=(13, 14), small=(14, 17), last_pos2=(17, 26),
              last_angle1=(26, 35), last_angle2=(35, 44), max_strain=(44, 47),
              unused=(47, 64))


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _make(n, seed, dtype=jnp.float32, **env_kw):
    """tests/test_fused_diff.py `_make`: (batched state, body, sim, env, dt)."""
    rng = np.random.default_rng(seed)
    structure = rng.integers(0, 5, size=(n, n, n)).astype(np.int32)
    structure[n // 2, n // 2, 0] = 3
    phase = rng.uniform(-1, 1, size=(n, n, n))
    jb = j_build_body(structure, j_palette(j_default_palette()),
                      phase_offset=phase, dtype=dtype)
    sim, env = JSim(init_cm_time=0.0), JEnv(**env_kw)
    dt = jnp.asarray(j_calc_max_dt(jb)) * jnp.asarray(sim.dt_frac)
    state = j_init_state(jb, dtype=dtype)
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), state)
    return batched, state, jb, sim, env, dt


def _port(jb, sim, env, tdtype=torch.float32):
    return (convert.body_from_numpy(_np(jb), dtype=tdtype),
            convert.sim_params_from_jax(sim), convert.env_params_from_jax(env))


def _both(n, seed, steps, K, n_segs, **env_kw):
    """The JAX and the port's DiffRollout on one design, with the packed
    start state of each and the controls (B, K, n, n, n)."""
    batched, _, jb, sim, env, dt = _make(n, seed, **env_kw)
    jdr = JDiffRollout(jb, sim, env, num_steps=steps, num_knots=K, dt=dt,
                       batch=B, n_segs=n_segs, interpret=True)
    body, psim, penv = _port(jb, sim, env)
    dr = DiffRollout(body, psim, penv, num_steps=steps, num_knots=K,
                     dt=float(dt), batch=B, n_segs=n_segs)
    jsp = jdr.init_packed(batched)
    sp = torch.as_tensor(np.array(jsp)[:, :, :n ** 3]).contiguous()
    return jdr, jsp, dr, sp, body


def test_segmented_forward_matches_full_and_jax():
    """(a) Chaining 3 segments equals one 24-step launch of the port bit for
    bit (the same plain step underneath), and the boundary CoM trace follows
    the JAX DiffRollout's to 2e-6 m (a voxel is 0.01 m): the float32
    trajectories of the two packages part once the quaternion snap fires,
    by up to 2e-5 m in a voxel's position within 24 steps, less in the
    mean."""
    n, steps, K = 4, 24, 4
    jdr, jsp, dr, sp, body = _both(n, 5, steps, K, 3)
    assert dr.total_steps == steps and dr.seg_steps == 8
    u = np.random.default_rng(2).uniform(
        -0.05, 0.05, size=(B, K, n, n, n)).astype(np.float32)
    cms, sp_f, stats_f = dr(sp, dr.stats0, dr.pack_controls(torch.as_tensor(u)))
    whole, whole_stats = fr.fused_call(
        sp, dr.body_packed, dr.stats0, None,
        control_packed=dr.pack_controls(torch.as_tensor(u)).contiguous(),
        **dict(dr._kw, num_steps=steps, flags=dict(dr._kw["flags"], segmented=False),
               total_steps=None))
    assert torch.equal(sp_f, whole)
    assert torch.equal(stats_f[:, :fr._S_INICM], whole_stats[:, :fr._S_INICM])
    assert torch.equal(cms[-1], dr.cm_y(whole, whole_stats))
    assert cms.shape == (3, B)

    jcms, jsp_f, _ = jdr(jsp, jdr.stats0, jdr.pack_controls(jnp.asarray(u)))
    np.testing.assert_allclose(cms.numpy(), np.asarray(jcms), rtol=0, atol=2e-6)
    np.testing.assert_allclose(sp_f[:, 0].numpy(), np.asarray(jsp_f)[:, 0, :n ** 3],
                               rtol=0, atol=2e-5)


def test_diff_gradients_match_jax_backward_kernel():
    """(b) d(final CoM-y)/d(control knots): the port (its `autograd.Function`
    over `fused_bwd_call`) against the JAX package (the backward Pallas
    kernel, interpret mode) on the inputs of
    tests/test_fused_diff.py::test_diff_gradients_match_jnp_bptt (3^3, 12
    steps, 3 knots, 3 segments, floor and gravity on), at that test's
    tolerance."""
    n, steps, K = 3, 12, 3
    jdr, jsp, dr, sp, body = _both(n, 7, steps, K, 3)
    u0 = np.random.default_rng(3).uniform(
        -0.03, 0.03, size=(K, n, n, n)).astype(np.float32)

    def f_jax(u):
        u8 = jnp.broadcast_to(u[None], (B,) + u.shape)
        cms, _, _ = jdr(jsp, jdr.stats0, jdr.pack_controls(u8))
        return cms[-1, 0]

    val_j, g_j = jax.value_and_grad(f_jax)(jnp.asarray(u0))

    u = torch.as_tensor(u0).requires_grad_(True)
    cms, _, _ = dr(sp, dr.stats0,
                   dr.pack_controls(u[None].expand((B,) + u.shape)).contiguous())
    (g_p,) = torch.autograd.grad(cms[-1, 0], u)
    np.testing.assert_allclose(float(cms[-1, 0].detach()), float(val_j), rtol=1e-5, atol=1e-9)
    gj = np.asarray(g_j).ravel()
    scale = np.abs(gj).max()
    assert scale > 0
    np.testing.assert_allclose(g_p.numpy().ravel(), gj, rtol=5e-3, atol=5e-4 * scale)


# water at 200 x the swimming experiment's drag coefficient, so that the
# drag's derivative weighs in 12 steps
WATER = dict(fluid_environment=True, gravity_enabled=False, floor_enabled=False,
             aggregate_drag_coefficient=1.5e5)
BPTT_CASES = {
    "floor_gravity": {}, "free": dict(gravity_enabled=False, floor_enabled=False),
    "fluid_face": WATER, "fluid_mesh": WATER, "growth": dict(growth_amplitude=0.3),
    "materials": {}}


def _bptt_design(case, n):
    """(state, body, sim, env, dt) in float64 of an eager BPTT case: the
    `_make` design on land; in water with the voxel-face drag, or with the
    facet drag in its +X/+Y/+Z shell; with random development fields
    whose ramps run within the case's 12 steps; or on the bilinear palette
    with the max-velocity clamp (tests/test_torch_fused_diff_materials.py),
    on the floor."""
    if case in ("floor_gravity", "free", "fluid_face"):
        _, state, jb, sim, env, dt = _make(n, 7, dtype=jnp.float64, **BPTT_CASES[case])
        return state, jb, sim, env, dt
    rng = np.random.default_rng(7)
    structure = rng.integers(0, 5, size=(n, n, n)).astype(np.int32)
    structure[n // 2, n // 2, 0] = 3
    phase = rng.uniform(-1, 1, size=(n, n, n))
    pal = j_palette(j_default_palette())
    env = JEnv(**BPTT_CASES[case])
    if case == "materials":
        from test_torch_fused_diff_materials import MAX_VEL, j_bilinear_palette

        jb = j_build_body(structure, j_palette(j_bilinear_palette()), phase_offset=phase,
                          dtype=jnp.float64)
        sim = JSim(init_cm_time=0.0, max_velocity_enabled=True, max_vox_vel_limit=MAX_VEL)
    elif case == "fluid_mesh":
        shell = ((0, 1),) * 3
        jb = j_attach_mesh_drag(j_build_body(np.pad(structure, shell), pal,
                                             phase_offset=np.pad(phase, shell),
                                             dtype=jnp.float64))
        sim = JSim(init_cm_time=0.0)
    else:
        def u(lo, hi):
            return rng.uniform(lo, hi, size=(n, n, n))

        probe = j_build_body(structure, pal, dtype=jnp.float64)
        step = float(j_calc_max_dt(probe)) * 0.9
        jb = j_build_body(structure, pal, phase_offset=phase, dtype=jnp.float64,
                          initial_voxel_size=u(0.006, 0.014),
                          final_voxel_size=u(0.006, 0.014),
                          growth_time=u(2 * step, 10 * step),
                          start_growth_time=u(0, 5 * step))
        sim = JSim(init_cm_time=4 * step, min_temp_fact=0.9)
    dt = jnp.asarray(j_calc_max_dt(jb)) * jnp.asarray(sim.dt_frac)
    return j_init_state(jb, dtype=jnp.float64), jb, sim, env, dt


@pytest.mark.parametrize("case", list(BPTT_CASES))
def test_eager_bptt_float64_matches_jax_grad(case):
    """(c) `torch.autograd.grad` through the eager `rollout` against
    `jax.grad` through the jnp `rollout`, both in float64, with controls:
    the derivative of the plain version itself, on land, in water with
    either drag model (a 3^3 design, in its 4^3 shell for the facet drag),
    with the development ramps, and on the bilinear palette with the
    max-velocity clamp (muscle bonds past yield and clamped voxels in the
    rollout). Measured agreement 7e-14 of the gradient's largest entry on
    land; held at 1e-9."""
    n, steps, K = 3, 12, 3
    state, jb, sim, env, dt = _bptt_design(case, n)
    assert (jb.mesh_drag is not None) == (case == "fluid_mesh")
    u0 = np.random.default_rng(3).uniform(-0.03, 0.03, size=(K,) + jb.occ.shape)

    def f_jax(u):
        return j_rollout(jb, sim, env, num_steps=steps, dt=dt, state=state,
                         control_sequence=u).final_cm[1]

    # jitted, so that a warm persistent compile cache spares the compile
    g_j = np.asarray(jax.jit(jax.grad(f_jax))(jnp.asarray(u0)))

    body, psim, penv = _port(jb, sim, env, torch.float64)
    pstate = convert.state_from_numpy(_np(state), dtype=torch.float64)
    u = torch.as_tensor(u0).requires_grad_(True)

    def grad():
        res = rollout(body, psim, penv, num_steps=steps, dt=float(dt), state=pstate,
                      control_sequence=u)
        return torch.autograd.grad(res.final_cm[1], u)[0]

    if case == "materials":
        from test_torch_b4_host import branch_counts

        g_p, yielded, clamped = branch_counts(grad)
        assert yielded > 0 and clamped > 0
    else:
        g_p = grad()
    scale = np.abs(g_j).max()
    assert scale > 0
    np.testing.assert_allclose(g_p.numpy(), g_j, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("pre_steps,seg_base", [(0, 0), (4, 4)],
                         ids=["rest_base0", "mid_base4"])
def test_fused_bwd_call_matches_jax_kernel(pre_steps, seg_base):
    """(d) `fused_bwd_call` with a random cotangent on all 47 carried
    channels against the JAX backward kernel in interpret mode (4 steps of
    a 12-step clock, 3 knots, 3^3): at rest with seg_base 0, and from the
    state 4 steps in with seg_base 4 under random controls, floor and
    gravity on.

    The rest case is exact rest (the stats rows' temperature amplitude and
    gravity set to zero, zero controls; the floor stays on and is touched
    with zero penetration), where every guard of the step fires at every
    step (identity quaternions, zero strains and velocities, the max-strain
    tie) and both packages keep the state they started from (identity
    quaternions exactly; float32 lattice positions leave strains of 1e-7,
    which move nothing by more than 1e-9 m). From rest under forces the comparison would be
    ill-posed in float32: the quaternion snap (`w >= 1`) is then decided by
    the last bit, which XLA's FMA contraction and eager torch round
    differently (one voxel in 216 snaps differently within 4 steps), and the
    snap cuts the cotangent.

    Each channel group at rtol 5e-3 / atol 2e-3 of the group's largest JAX
    value (measured worst: 8e-4, the quaternion group, whose cotangent
    passes through the normalisation and the near-identity log map, where
    the last bits of the recomputed states matter most; the JAX test's 5e-4
    is met by every other group). Over occupied voxels and existing bonds:
    an empty cell and a missing bond feed nothing, and the JAX kernel
    carries their state through unchanged where the eager step (the port's
    plain version, like the jnp step) resets it to constants, so their own
    cotangents differ by design."""
    n, K, total, S = 3, 3, 12, 4
    jdr, jsp, dr, sp, body = _both(n, 7, total, K, total // S)
    V = n ** 3
    rng = np.random.default_rng(9)
    u = rng.uniform(-0.05, 0.05, size=(B, K, n, n, n)).astype(np.float32)
    jctrl = jdr.pack_controls(jnp.asarray(u))
    jstats = jdr.stats0
    if not pre_steps:
        jctrl = jnp.zeros_like(jctrl)
        jstats = jstats.at[..., fr._S_TAMP].set(0.0).at[..., fr._S_GRAV].set(0.0)
    for s in range(pre_steps // S):
        jsp, jstats = jdr._seg(jsp, jstats, jctrl, jnp.asarray(s * S, jnp.float32))
    cot = np.zeros((B, fr.C_S, jsp.shape[2]), np.float32)
    cot[:, :fr._TSAVG, :V] = rng.standard_normal((B, fr._TSAVG, V))

    # the JAX custom_vjp's backward is the Pallas backward kernel
    _, vjp = jax.vjp(lambda s, c: jdr._seg(s, jstats, c, jnp.asarray(seg_base, jnp.float32))[0],
                     jsp, jctrl)
    j_cs, j_cu = (np.asarray(a) for a in vjp(jnp.asarray(cot)))

    state = torch.as_tensor(np.array(jsp)[:, :, :V]).contiguous()
    stats = torch.as_tensor(np.array(jstats).reshape(B, fr.C_STAT)).contiguous()
    ctrl = torch.as_tensor(np.array(jctrl)[:, :, :V]).contiguous()
    p_cs, p_cu = fr.fused_bwd_call(state, dr.body_packed, stats, ctrl, seg_base,
                                   torch.as_tensor(cot[:, :, :V]).contiguous(), **dr._kw)
    assert p_cs.shape == (B, fr.C_S, V) and p_cu.shape == (B, K, V)
    assert bool((p_cs[:, fr._TSAVG:] == 0).all())
    occ = body.occ.reshape(-1).numpy()
    bonds = body.bond_mask.reshape(3, -1).numpy()
    for name, (a, b) in GROUPS.items():
        ref, got = j_cs[:, a:b, :V], p_cs[:, a:b].numpy()
        if name in ("last_pos2", "last_angle1", "last_angle2"):
            live = np.repeat(bonds, 3, axis=0)
        elif name == "max_strain":
            live = bonds
        else:
            live = np.broadcast_to(occ, (b - a, V))
        ref, got = ref * live, got * live
        np.testing.assert_allclose(got, ref, rtol=5e-3,
                                   atol=2e-3 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=name)
    ref = j_cu[:, :, :V]
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(p_cu.numpy(), ref, rtol=5e-3,
                               atol=5e-4 * np.abs(ref).max())
    if not pre_steps:  # the state stayed at rest
        end = fr.fused_call(state, dr.body_packed, stats, None, control_packed=ctrl,
                            seg_base=0, **dr._kw)[0]
        assert torch.equal(end[:, fr._QUAT:fr._LIN], state[:, fr._QUAT:fr._LIN])
        torch.testing.assert_close(end[:, :fr._QUAT], state[:, :fr._QUAT], rtol=0, atol=1e-9)


def test_rest_state_gradients_are_finite_and_zero_cotangent_gives_zeros():
    """(e) At rest every guard of the step fires (identity quaternions, zero
    strains and velocities): the gradients are finite; and rows that receive
    no cotangent give exactly zero."""
    n, K = 3, 3
    _, _, dr, sp, _ = _both(n, 7, 12, K, 3)
    V = n ** 3
    ctrl = torch.zeros((B, K, V))
    cot = torch.zeros((B, fr.C_S, V))
    cot[0, :fr._TSAVG] = torch.as_tensor(
        np.random.default_rng(0).standard_normal((fr._TSAVG, V)).astype(np.float32))
    cs, cu = fr.fused_bwd_call(sp, dr.body_packed, dr.stats0, ctrl, 0, cot, **dr._kw)
    assert bool(torch.isfinite(cs).all()) and bool(torch.isfinite(cu).all())
    assert float(cu[0].abs().max()) > 0
    assert bool((cs[1:] == 0).all()) and bool((cu[1:] == 0).all())


def test_fused_bwd_call_refuses_what_is_outside_the_envelope():
    """(f) Every flag outside `diff_envelope_ok` raises NotImplementedError
    naming it, and so do sources; a launch without knots or without the
    segmented mode raises ValueError. Water with either drag model, the
    development flags, and on land nonlinear materials and the max-velocity
    clamp (B4's material instance) are inside the envelope and run."""
    n, K = 3, 3
    _, _, dr, sp, _ = _both(n, 7, 12, K, 3)
    V = n ** 3
    ctrl = torch.zeros((B, K, V))
    cot = torch.zeros((B, fr.C_S, V))
    args = (sp, dr.body_packed, dr.stats0, ctrl, 0, cot)
    assert {"collision", "collision_compact", "volume",
            "equilibrium", "plasticity", "needle", "falling", "ndbv", "window",
            "ballistic", "mdl_data", "bc"} == set(fr._DIFF_REFUSED)
    for flag in fr._DIFF_REFUSED:
        kw = dict(dr._kw, flags=dict(dr._kw["flags"], **{flag: True}))
        assert not fr.diff_envelope_ok(kw["flags"], kw["scalars"])
        with pytest.raises(NotImplementedError, match=f"'{flag}'"):
            fr.fused_bwd_call(*args, **kw)
    with pytest.raises(NotImplementedError, match="'sources'"):
        fr.fused_bwd_call(*args, **dict(dr._kw, scalars=dict(dr._kw["scalars"],
                                                             sources=(1,))))
    # inside now: water with the voxel-face or the facet drag, development,
    # nonlinear materials and the clamp on land
    inside = [dict(fluid=True, gravity=False, floor=False),
              dict(fluid=True, fluid_mesh=True, gravity=False, floor=False),
              dict(nonlinear=True), dict(max_vel=True), dict(nonlinear=True, max_vel=True)]
    inside += [{k: True} for k in fr._K1_DEVO_FLAGS]
    for extra in inside:
        flags = dict(dr._kw["flags"], **extra)
        assert fr.diff_envelope_ok(flags, dr._kw["scalars"])
        cs, cu = fr.fused_bwd_call(*args, **dict(dr._kw, flags=flags, num_steps=2))
        assert bool(torch.isfinite(cs).all()) and bool(torch.isfinite(cu).all())
    assert not fr.diff_envelope_ok(dr._kw["flags"], dict(dr._kw["scalars"], sources=(1,)))
    assert fr.diff_envelope_ok(dr._kw["flags"], dr._kw["scalars"])
    with pytest.raises(ValueError):
        fr.fused_bwd_call(*args, **dict(dr._kw, n_knots=0))
    with pytest.raises(ValueError):
        fr.fused_bwd_call(*args, **dict(dr._kw, flags=dict(dr._kw["flags"], segmented=False)))
    with pytest.raises(ValueError):
        fr.fused_bwd_call(sp, dr.body_packed, dr.stats0, ctrl[:, :2], 0, cot, **dr._kw)
    with pytest.raises(TypeError):
        fr.fused_bwd_call(sp, dr.body_packed, dr.stats0, ctrl, 0, cot.double(), **dr._kw)
    from evosoro_tpu_torch.core.materials import build_body, palette_from_list
    from evosoro_tpu_torch.core.types import evosoro_default_palette

    body = build_body(np.full((3, 3, 3), 3, np.int32),
                      palette_from_list(evosoro_default_palette()), device="cpu")
    with pytest.raises(ValueError):
        DiffRollout(body, SimParams(self_collisions_enabled=True,
                                    volume_effects_enabled=True), EnvParams(),
                    num_steps=12, num_knots=3, dt=1e-5, batch=B)
    # a facet-drag body without its +X/+Y/+Z shell is refused by name, as
    # `supports` refuses it; in its shell it is inside
    from evosoro_tpu_torch.envs.drag import attach_mesh_drag

    water = EnvParams(fluid_environment=True, gravity_enabled=False, floor_enabled=False)
    with pytest.raises(ValueError, match="empty layer"):
        DiffRollout(attach_mesh_drag(body), SimParams(), water, num_steps=12,
                    num_knots=3, dt=1e-5, batch=B)
    shelled = attach_mesh_drag(build_body(np.pad(np.full((3, 3, 3), 3, np.int32),
                                                 ((0, 1),) * 3),
                                          palette_from_list(evosoro_default_palette()),
                                          device="cpu"))
    dr_w = DiffRollout(shelled, SimParams(), water, num_steps=12, num_knots=3, dt=1e-5,
                       batch=B)
    assert fr.facet_drag(dr_w._kw["flags"])
