"""K1's and B4's material, compact-contact and volume instances in water and
with growth, held against the JAX package on the CPU.

The port's plain versions (`fused_rollout` on CPU tensors: the eager step
looped; `DiffRollout` on CPU tensors: torch autograd through it) against
the JAX package on the same inputs (numpy from a seed), one combined case
per variant:

- (face) the voxel-face drag with bilinear stress, plasticity, the
  max-velocity clamp and volume effects (which take the stress's place);
- (mesh) the facet drag with bilinear stress: heterogeneous bonds past
  their yield strain, whose per-side strains the facets' corners read (the
  stress equalization's, not the linear fixed point's);
- (devo) growth with an MDL_DATA tissue, a bilinear muscle, BC regions (a
  pinned face) and self-contact through the compact table, the voxels grown
  into contact.

JAX's kernel in interpret mode takes tens of seconds a case to compile on
this repository's test host (the three cases and the three BPTTs about
five minutes), more than this slice's tests may add; so the JAX side is
stored in
`fixtures/mat_variants_jax.npz`, written by
`fixtures/make_mat_variants_jax.py` from the cases built here. The fixture
also holds the inputs JAX was given; the tests rebuild them from the same
seed, check that they are the same and that the port packs them as JAX
does, and hold the port's outputs to the stored ones. Regenerate it
whenever a case, either package's kernels or packing change.

Forward: two steps (three with growth, so that the grown voxels touch;
three with the facet drag, at a drag of 1.5e7) from a fast-moving state
turned away from the identity, channel by channel at
tests/test_fused_rollout.py's
tolerances (pos rtol 2e-5 atol 1e-8 as tests/test_torch_fluid.py holds the
facet drag; scale rtol 1e-6; small_angle equal; momenta at rtol 1e-3
atol 5e-5, the fluid tests' bound for drag of 1.5e5; with the nonlinear
stress and plasticity, pos at rtol 2e-4 atol 5e-8 and the strain offset
at rtol 1e-4, tests/test_torch_materials.py's). Each case also shows what
it can see: the facet drag's corners on the linear fixed point's per-side
strains, growth without contact, the clamp off.

Backward: the gradient of the last segment's CoM-y of robot 0 by the
control knots through `DiffRollout` (3^3 designs on the bilinear palette
with the clamp, 12 steps in 3 segments, 3 knots) against `jax.grad`
through JAX's jnp rollout, at tests/test_torch_fused_diff.py's tolerances
(rtol 5e-3, atol 5e-4 of the gradient's largest entry). JAX's own backward
kernel parts from its jnp BPTT on bilinear palettes near the identity
(ROADMAP.md section C), so the port is held to the BPTT.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evosoro_tpu.core.types as jt
from evosoro_tpu.core.collision import attach_collision_system as j_attach_collision
from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.envs.drag import attach_mesh_drag as j_attach_mesh_drag
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.ops import fused_rollout as fr
from evosoro_tpu_torch.ops.fused_diff import DiffRollout
from test_torch_b4_host import branch_counts

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "mat_variants_jax.npz")
FLUID_KW = dict(fluid_environment=True, gravity_enabled=False, floor_enabled=False,
                aggregate_drag_coefficient=1.5e5)
# the state fields compared, and the forward launches' batch
FIELDS = ("pos", "quat", "linmom", "angmom", "scale", "small_angle", "strain_offset",
          "max_strain")
B_FWD = 2
# the backward cases: batch, grid, steps, knots, segments
B, N, STEPS, K, N_SEGS = 2, 3, 12, 3, 3
MAX_VEL = 1e-3  # bench.MATERIALS_MAX_VEL


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def j_materials_palette(tissue=True):
    """The default palette with the muscles (3, 4) bilinear, yielding at 2 %
    strain to a tenth of their stiffness (`bench.bilinear_palette`) and,
    with `tissue`, the soft tissue (1) an MDL_DATA curve of 5 points
    (`bench.materials_palette`'s shape)."""
    mats = list(jt.evosoro_default_palette())
    for k in (2, 3):
        m = mats[k]
        mats[k] = jt.Material(m.id, m.name, m.elastic_mod, cte=m.cte, rgba=m.rgba,
                              mat_model=jt.MDL_BILINEAR, yield_stress=0.02 * m.elastic_mod,
                              plastic_mod=0.1 * m.elastic_mod)
    if tissue:
        m = mats[0]
        mats[0] = jt.Material(m.id, m.name, m.elastic_mod, cte=m.cte, rgba=m.rgba,
                              mat_model=jt.MDL_DATA, ss_strain=(0.0, 0.01, 0.02, 0.05, 0.1),
                              ss_stress=(0.0, 5e4, 9e4, 1.6e5, 2.2e5))
    return mats


def _moving(state, occ, scale, seed):
    """The state with random momenta of `scale` and every voxel turned by
    0.2-0.5 rad about a random axis: far from the identity, where the
    step's quaternion snap (w >= 1), decided by the last bit that XLA's
    contraction of multiply-adds and eager torch round differently
    (ROADMAP.md section C), cannot fire."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=state.quat.shape[:-1] + (3,))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    half = 0.5 * rng.uniform(0.2, 0.5, size=state.quat.shape[:-1] + (1,))
    quat = np.concatenate([np.cos(half), np.sin(half) * axis], -1).astype(np.float32)
    occ = np.asarray(occ)[..., None]
    return state.replace(
        linmom=jnp.asarray(rng.normal(0, scale, size=state.linmom.shape).astype(np.float32))
        * occ,
        quat=jnp.asarray(np.where(occ, quat, np.asarray(state.quat))))


def forward_case(name):
    """(JAX body, sim, env, dt, batched moving state, steps) of a forward case."""
    rng = np.random.default_rng(dict(face=31, mesh=32, devo=33)[name])
    if name == "devo":
        # a full 7^3 block, so that the JAX package's lane-padded rule takes
        # the compact pass (218 surface voxels, 256 < 384 lanes); initial
        # sizes up to 1.5 L grow the voxels into their diagonal neighbours
        # in the first step, the growth window runs within the launch
        n = 7
        structure = rng.integers(1, 5, size=(n, n, n)).astype(np.int32)
        dof = np.zeros((n, n, n), np.int32)
        dof[0] = jt.DOF_ALL
        disp = np.zeros((n, n, n, 3))
        disp[0, ..., 0] = 2e-4
        fields = dict(initial_voxel_size=rng.uniform(0.013, 0.015, size=(n, n, n)),
                      final_voxel_size=rng.uniform(0.006, 0.014, size=(n, n, n)),
                      growth_time=rng.uniform(1e-5, 4e-5, size=(n, n, n)),
                      start_growth_time=rng.uniform(0.0, 2e-5, size=(n, n, n)))
        jb = j_build_body(structure, j_palette(j_materials_palette()),
                          phase_offset=rng.uniform(-1, 1, size=(n, n, n)), dof_fixed=dof,
                          external_disp=disp, dtype=jnp.float32, **fields)
        jb = j_attach_collision(jb)
        sim = jt.SimParams(init_cm_time=0.0, self_collisions_enabled=True)
        env = jt.EnvParams(growth_amplitude=1.0, gravity_enabled=False, floor_enabled=False)
        steps, speed = 3, 0.05
    else:
        n = 4
        mesh = name == "mesh"
        m = n + 1 if mesh else n
        structure = np.zeros((m, m, m), np.int32)
        structure[:n, :n, :n] = rng.integers(0, 5, size=(n, n, n))
        structure[:n, :n, 0] = 3
        phase = rng.uniform(-1, 1, size=(m, m, m))
        jb = j_build_body(structure, j_palette(j_materials_palette(tissue=False)),
                          phase_offset=phase, dtype=jnp.float32)
        env = jt.EnvParams(**FLUID_KW)
        steps, speed = 2, 0.3
        if mesh:
            # a drag of 1.5e7 over 3 steps, so that the per-side strains of
            # the facets' corners weigh several times the momenta's tolerance
            jb = j_attach_mesh_drag(jb)
            sim = jt.SimParams(init_cm_time=0.0)
            env = env.replace(aggregate_drag_coefficient=1.5e7)
            steps = 3
        else:
            sim = jt.SimParams(init_cm_time=0.0, plasticity_enabled=True,
                               max_velocity_enabled=True, max_vox_vel_limit=5e-4,
                               volume_effects_enabled=True)
    vol = bool(sim.volume_effects_enabled)
    dt = float(j_calc_max_dt(jb, vol)) * float(sim.dt_frac)
    state = j_init_state(jb, dtype=jnp.float32, volume_effects=vol)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B_FWD,) + x.shape), state)
    return jb, sim, env, dt, _moving(batched, jb.occ, speed, 7), steps


def backward_case(name):
    """(JAX body, sim, env, dt, controls (K, X, Y, Z)) of a backward case: a
    random 3^3 design with a muscle column on the bilinear palette with the
    clamp, in water (a 4^3 grid with the facet drag's shell for `mesh`) or
    with growth fields."""
    rng = np.random.default_rng(dict(face=41, mesh=42, devo=43)[name])
    m = N + 1 if name == "mesh" else N
    structure = np.zeros((m, m, m), np.int32)
    structure[:N, :N, :N] = rng.integers(0, 5, size=(N, N, N))
    structure[N // 2, N // 2, :N] = 3
    phase = rng.uniform(-1, 1, size=(m, m, m))
    kw = {}
    if name == "devo":
        kw = dict(initial_voxel_size=rng.uniform(0.008, 0.012, size=(m, m, m)),
                  final_voxel_size=rng.uniform(0.008, 0.012, size=(m, m, m)),
                  growth_time=rng.uniform(1e-4, 4e-4, size=(m, m, m)),
                  start_growth_time=rng.uniform(0.0, 2e-4, size=(m, m, m)))
    jb = j_build_body(structure, j_palette(j_materials_palette(tissue=False)),
                      phase_offset=phase, dtype=jnp.float32, **kw)
    sim = jt.SimParams(init_cm_time=0.0, max_velocity_enabled=True, max_vox_vel_limit=MAX_VEL)
    if name == "devo":
        env = jt.EnvParams(gravity_enabled=False, floor_enabled=False, growth_amplitude=0.8)
    else:
        env = jt.EnvParams(**dict(FLUID_KW, aggregate_drag_coefficient=750.0))
        if name == "mesh":
            jb = j_attach_mesh_drag(jb)
    dt = float(j_calc_max_dt(jb)) * float(sim.dt_frac)
    u0 = rng.uniform(-0.05, 0.05, size=(K,) + jb.occ.shape).astype(np.float32)
    return jb, sim, env, dt, u0


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(FIXTURE))


def _port(jb, sim, env):
    body = convert.body_from_numpy(_np(jb))
    return body, convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)


def _forward(name, fixture, monkeypatch):
    """The port's forward launch of a case, after checking that the inputs
    are the fixture's and that the port packs them as JAX did."""
    jb, sim, env, dt, moving, steps = forward_case(name)
    body, psim, penv = _port(jb, sim, env)
    ref = {k[len(name) + 5:]: v for k, v in fixture.items() if k.startswith(name + "_fwd_")}
    np.testing.assert_array_equal(np.asarray(moving.linmom), ref["in_linmom"])
    np.testing.assert_allclose(dt, float(ref["dt"]), rtol=1e-12)
    V = int(np.prod(jb.occ.shape))
    np.testing.assert_allclose(fr.pack_body(body).numpy(), ref["body"][..., :V], rtol=1e-6,
                               atol=0)
    assert fr.supports(body, psim, penv)
    flags = fr.launch_flags(body, psim, penv)
    if name == "devo":
        monkeypatch.setenv("EVOSORO_TPU_COLL_COMPACT", "1")
    state = convert.state_from_numpy(_np(moving))
    return body, psim, penv, dt, state, steps, flags, ref


def _assert_close(out, ref, pos_tol, skip=()):
    np.testing.assert_allclose(out.pos.numpy(), ref["pos"], **pos_tol)
    np.testing.assert_allclose(out.scale.numpy(), ref["scale"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(out.linmom.numpy(), ref["linmom"], rtol=1e-3, atol=5e-5)
    if "quat" not in skip:
        np.testing.assert_allclose(out.quat.numpy(), ref["quat"], rtol=2e-5, atol=1e-7)
    np.testing.assert_array_equal(out.small_angle.numpy(), ref["small_angle"])
    if "strain_offset" not in skip:
        soff = ref["strain_offset"]
        np.testing.assert_allclose(out.strain_offset.numpy(), soff, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(soff).max(), 1e-30))


def test_face_drag_with_materials_and_volume_effects_matches_jax_kernel(fixture, monkeypatch):
    """(face) Plasticity's offset and the clamp act, volume effects take the
    stress's place; a launch without the clamp parts from the kernel. The
    strain offset is held to JAX's jnp step: JAX's kernel takes the
    volume effects' thermal stress off before plasticity
    (evosoro_tpu/ops/fused_rollout.py:504-507, then :558-572), its jnp
    step after it (evosoro_tpu/core/step.py:331-370), and so parts from
    its own step on the offset (ROADMAP.md section C); the port follows the
    jnp step, to which it is held in every field."""
    body, psim, penv, dt, state, steps, flags, ref = _forward("face", fixture, monkeypatch)
    for k in ("fluid", "nonlinear", "plasticity", "max_vel", "volume"):
        assert flags[k], k
    assert not fr.facet_drag(flags)
    out, _ = fr.fused_rollout(state, body, psim, penv, num_steps=steps, dt=dt)
    jnp_ref = {k[9:]: v for k, v in fixture.items() if k.startswith("face_jnp_")}
    _assert_close(out, jnp_ref, dict(rtol=2e-4, atol=5e-8))
    _assert_close(out, ref, dict(rtol=2e-4, atol=5e-8), skip=("strain_offset",))
    # the coupling carry as the kernels pack it (the jnp step keeps its
    # own layout of the two sides)
    np.testing.assert_allclose(out.ts_sum.numpy(), ref["ts_sum"], rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(out.cs_area.numpy(), ref["cs_area"], rtol=1e-4, atol=0)
    # the reference's kernel and its jnp step part on the offset
    soff = jnp_ref["strain_offset"]
    assert not np.allclose(ref["strain_offset"], soff, rtol=1e-4, atol=1e-4 * np.abs(soff).max())
    assert float(out.strain_offset.abs().max()) > 1e-4  # plasticity acted
    free, _ = fr.fused_rollout(state, body, psim.replace(max_velocity_enabled=False), penv,
                               num_steps=steps, dt=dt)
    assert not np.allclose(free.pos.numpy(), ref["pos"], rtol=2e-4, atol=5e-8)


def test_facet_drag_with_bilinear_stress_matches_jax_kernel(fixture, monkeypatch):
    """(mesh) Heterogeneous bonds strain past their yield point, and the
    facets' corners read the stress equalization's per-side strains: a
    plain version whose corners read the linear fixed point's parts from
    the kernel."""
    from unittest import mock

    from evosoro_tpu_torch.core import step as step_mod

    body, psim, penv, dt, state, steps, flags, ref = _forward("mesh", fixture, monkeypatch)
    assert fr.facet_drag(flags) and flags["nonlinear"]
    (out, _), yielded, _ = branch_counts(
        lambda: fr.fused_rollout(state, body, psim, penv, num_steps=steps, dt=dt))
    hetero = ~body.bond_homogeneous & body.bond_mask
    assert yielded > 0 and bool(hetero.any())
    _assert_close(out, ref, dict(rtol=2e-4, atol=5e-8), skip=("strain_offset",))

    nonlinear = step_mod._nonlinear_stress

    def linear_sides(d, strain, b):
        stress, _, _ = nonlinear(d, strain, b)
        e1, e2 = b.bond_e1[..., d, :, :, :], b.bond_e2[..., d, :, :, :]
        s_sum = e1 + e2
        hom = b.bond_homogeneous[..., d, :, :, :] | (torch.abs(e1 - e2)
                                                     <= 0.0005 * torch.abs(s_sum))
        return (stress, torch.where(hom, strain, 2.0 * step_mod._safe_div(e2, s_sum) * strain),
                torch.where(hom, strain, 2.0 * step_mod._safe_div(e1, s_sum) * strain))

    with mock.patch.object(step_mod, "_nonlinear_stress", linear_sides):
        wrong, _ = fr.fused_rollout(state, body, psim, penv, num_steps=steps, dt=dt)
    assert not np.allclose(wrong.linmom.numpy(), ref["linmom"], rtol=1e-3, atol=5e-5)


def test_growth_with_mdl_data_bc_and_compact_contact_matches_jax_kernel(fixture, monkeypatch):
    """(devo) The compact pass runs (S < V) on voxels grown into contact, the
    pinned face sits at its prescribed place exactly; without contact the
    port parts from the kernel. The quaternions are held at the momenta's
    bound of their own scale (rtol 1e-3 of the largest component): under
    contact forces that move momenta by 16 in 3 steps, JAX's kernel and its
    jnp step part by 2.3e-7 in them, past tests/test_fused_rollout.py's
    atol of 1e-7 (on the CPU); the port parts from the kernel by 5.3e-7."""
    body, psim, penv, dt, state, steps, flags, ref = _forward("devo", fixture, monkeypatch)
    for k in ("nonlinear", "mdl_data", "bc", "use_init_size", "use_final_size"):
        assert flags[k], k
    c0 = fr.FUSED_ROLLOUT_COMPACT_LAUNCHES
    seen = []
    real = fr.fused_call

    def spy(*a, **kw):
        seen.append(dict(kw["flags"]))
        return real(*a, **kw)

    monkeypatch.setattr(fr, "fused_call", spy)
    out, _ = fr.fused_rollout(state, body, psim, penv, num_steps=steps, dt=dt)
    assert seen and seen[0]["collision_compact"] and fr.FUSED_ROLLOUT_COMPACT_LAUNCHES == c0
    _assert_close(out, ref, dict(rtol=2e-4, atol=5e-8), skip=("quat",))
    np.testing.assert_allclose(out.quat.numpy(), ref["quat"], rtol=0,
                               atol=1e-3 * np.abs(ref["quat"][..., 1:]).max())
    occ0 = body.occ[0]
    pinned = (body.nom_pos[0] + body.external_disp[0])[occ0]
    assert torch.equal(out.pos[:, 0][:, occ0], pinned.expand(B_FWD, -1, -1))
    free, _ = fr.fused_rollout(state, body, psim.replace(self_collisions_enabled=False), penv,
                               num_steps=steps, dt=dt)
    assert not np.allclose(free.linmom.numpy(), ref["linmom"], rtol=1e-3, atol=5e-5)


@pytest.mark.parametrize("name", ["face", "mesh", "devo"])
def test_diff_rollout_with_bilinear_stress_and_clamp_matches_jax_bptt(fixture, name):
    """d(final CoM-y of robot 0)/d(control knots) through `DiffRollout` in
    each variant against `jax.grad` through JAX's jnp rollout, with muscle
    bonds past yield and clamped voxels in the rollout; and the segment
    CoMs against JAX's jnp rollout's."""
    jb, sim, env, dt, u0 = backward_case(name)
    ref = {k[len(name) + 5:]: v for k, v in fixture.items() if k.startswith(name + "_bwd_")}
    np.testing.assert_array_equal(ref["u0"], u0)
    body, psim, penv = _port(jb, sim, env)
    scalars = fr.kernel_scalars(body.nominal_size, psim, penv)
    assert json.loads(json.dumps(scalars, sort_keys=True)) == json.loads(str(ref["scalars"]))
    dr = DiffRollout(body, psim, penv, num_steps=STEPS, num_knots=K, dt=dt, batch=B,
                     n_segs=N_SEGS)
    f = dr._kw["flags"]
    assert f["nonlinear"] and f["max_vel"]
    assert fr.facet_drag(f) == (name == "mesh") and bool(f.get("use_final_size")) == (
        name == "devo")
    from evosoro_tpu_torch.core.rollout import init_state

    sp = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
    u = torch.as_tensor(u0).requires_grad_(True)

    def grad():
        cms, _, _ = dr(sp, dr.stats0,
                       dr.pack_controls(u[None].expand((B,) + u.shape)).contiguous())
        return cms, torch.autograd.grad(cms[-1, 0], u)[0]

    (cms, g), yielded, clamped = branch_counts(grad)
    assert yielded > 0 and clamped > 0, (yielded, clamped)
    np.testing.assert_allclose(float(cms[-1, 0]), float(ref["final_cm_y"]), rtol=0, atol=2e-6)
    gj = ref["grad_jnp"]
    scale = np.abs(gj).max()
    assert scale > 0
    np.testing.assert_allclose(g.numpy(), gj, rtol=5e-3, atol=5e-4 * scale)
