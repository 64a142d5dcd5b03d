"""The port in water, held against the JAX package on the same inputs.

Inputs are made with numpy from a seed and go through both packages:
- the eager `sim_step` and `rollout` with the voxel-face drag and with the
  facet drag on the deformed mesh, in float64 (as tests/test_torch_rollout.py
  holds the land rollout: in float32 the quaternion's identity snap turns
  ulp differences into jumps). After two steps the two agree to the last
  bits; over a rollout the snap (`w >= 1`) flips on the last bit, so metres
  are held at rtol 1e-7 / atol 1e-9 and momenta at rtol 1e-6 / atol 1e-9;
- `fused_rollout` on CPU tensors (the plain version of K1's fluid variants)
  against the JAX Pallas kernel in interpret mode, float32, on the bodies of
  tests/test_fused_rollout.py (`test_fused_fluid_drag_matches_jnp`,
  `test_fused_mesh_drag_matches_jnp`): at that file's tolerances (pos rtol
  2e-5 atol 1e-8, scale rtol 1e-6, linmom rtol 1e-3 atol 5e-5) while
  nothing has snapped, at metric level over the 100 actuated steps;
- `supports()`: the shell rule of the facet drag and the shared-memory rule.
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
from evosoro_tpu.envs.drag import attach_mesh_drag as j_attach_mesh_drag
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.core import (
    EnvParams,
    SimParams,
    build_body,
    evosoro_default_palette,
    init_state,
    palette_from_list,
    rollout,
    sim_step,
)
from evosoro_tpu_torch.envs.drag import attach_mesh_drag
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)
jfr = importlib.import_module("evosoro_tpu.ops.fused_rollout")

METRES = dict(rtol=1e-7, atol=1e-9)
MOMENTA = dict(rtol=1e-6, atol=1e-9)
FLUID_KW = dict(fluid_environment=True, gravity_enabled=False, floor_enabled=False,
                aggregate_drag_coefficient=375.0)


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _design(n, seed, shell, dtype):
    """The bodies of tests/test_fused_rollout.py's fluid tests: random
    materials with a layer of muscle, in a one-cell shell for the mesh."""
    rng = np.random.default_rng(seed)
    m = n + 1 if shell else n
    structure = np.zeros((m, m, m), dtype=np.int32)
    structure[:n, :n, :n] = rng.integers(0, 5, size=(n, n, n))
    structure[:n, :n, 0] = 3
    phase = rng.uniform(-1, 1, size=(m, m, m))
    jb = j_build_body(structure, j_palette(j_default_palette()), phase_offset=phase,
                      dtype=dtype)
    return j_attach_mesh_drag(jb) if shell else jb


@pytest.mark.parametrize("model", ["face", "mesh"])
def test_eager_fluid_step_and_rollout_match_jax_in_float64(model):
    jb = _design(4, 13 if model == "mesh" else 11, model == "mesh", jnp.float64)
    sim, env = JSim(init_cm_time=0.0), JEnv(**FLUID_KW)
    dt = float(j_calc_max_dt(jb)) * 0.9
    body = convert.body_from_numpy(_np(jb), dtype=torch.float64)
    assert (body.mesh_drag is not None) == (model == "mesh")
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)

    # two steps from a moving state: before any snap, to the last bits
    rng = np.random.default_rng(1)
    st = j_init_state(jb, dtype=jnp.float64)
    st = st.replace(linmom=jnp.asarray(rng.normal(0, 1e-3, size=st.linmom.shape))
                    * jb.occ[..., None])
    s = convert.state_from_numpy(_np(st), dtype=torch.float64)
    step = jax.jit(lambda x: j_sim_step(x, jb, sim, env, dt))
    for _ in range(2):
        st, s = step(st), sim_step(s, body, psim, penv, dt)
    for name in ("pos", "linmom", "angmom", "scale"):
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(st, name)),
                                   rtol=1e-12, atol=1e-16, err_msg=name)

    # an actuated swim of 60 steps through `rollout`
    ref = jax.jit(lambda: j_rollout(jb, sim, env, num_steps=60, dt=dt))()
    res = rollout(body, psim, penv, num_steps=60, dt=dt)
    assert float(np.abs(np.asarray(ref.final_state.linmom)).max()) > 0
    np.testing.assert_allclose(res.final_state.pos.numpy(),
                               np.asarray(ref.final_state.pos), **METRES)
    np.testing.assert_allclose(res.final_state.scale.numpy(),
                               np.asarray(ref.final_state.scale), rtol=1e-12)
    np.testing.assert_allclose(res.final_state.linmom.numpy(),
                               np.asarray(ref.final_state.linmom), **MOMENTA)
    np.testing.assert_allclose(res.final_cm.numpy(), np.asarray(ref.final_cm), **METRES)
    np.testing.assert_allclose(float(res.norm_final_dist), float(ref.norm_final_dist),
                               rtol=1e-5, atol=1e-8)
    assert not bool(res.diverged)


def test_fluid_actuation_ignores_damping_devo_and_clamps():
    """The land_water actuation: gated on temp_enabled alone, no amplitude
    damping, no development, no rate clamps, a hard floor at 0.1."""
    rng = np.random.default_rng(3)
    structure = np.full((3, 3, 3), 3, dtype=np.int32)
    pal = palette_from_list(evosoro_default_palette())
    damp = rng.uniform(0.1, 0.5, size=(3, 3, 3))
    plain = build_body(structure, pal, dtype=torch.float64)
    damped = build_body(structure, pal, temp_amp_damp=damp,
                        initial_voxel_size=np.full((3, 3, 3), 0.005),
                        final_voxel_size=np.full((3, 3, 3), 0.015),
                        growth_time=np.full((3, 3, 3), 1e-4),
                        start_growth_time=np.zeros((3, 3, 3)), dtype=torch.float64)
    sim = SimParams(init_cm_time=0.0, min_temp_fact=0.9)
    for env in (EnvParams(**dict(FLUID_KW, temp_amplitude=200.0)),
                EnvParams(**dict(FLUID_KW, temp_amplitude=200.0), vary_temp_enabled=False)):
        a, b = init_state(plain), init_state(damped)
        for _ in range(12):
            a, b = (sim_step(s, bd, sim, env, 2e-3) for s, bd in ((a, plain), (b, damped)))
        np.testing.assert_array_equal(a.scale.numpy(), b.scale.numpy())
        # 1 + 200 * 0.01 * sin(..) spans -1..3: floored at 0.1 L, unclamped above
        assert float(a.scale.min()) >= 0.1 * 0.01 - 1e-18
        assert float(a.scale.max()) > 2.0 * 0.01
    off = EnvParams(**dict(FLUID_KW, temp_enabled=False))
    assert torch.equal(sim_step(init_state(plain), plain, sim, off, 2e-3).scale,
                       init_state(plain).scale)


@pytest.mark.parametrize("model", ["face", "mesh"])
def test_fused_fluid_rollout_matches_jax_kernel(model):
    """`fused_rollout` on CPU tensors against the JAX Pallas kernel in
    interpret mode, float32, batch 2. Two steps from a fast-moving state
    under a drag coefficient of 1.5e5 (drag then moves the momenta by ten
    times the tolerance within two steps, and nothing has snapped yet) are
    held channel by channel at the JAX file's tolerances. Over its 100 actuated steps the
    two float32 paths part as on land (XLA contracts into FMA, eager torch
    does not, and the quaternion snap amplifies it: ROADMAP.md, section C):
    there positions are held inside the 5e-5 m drift band, the CoM's travel
    at rtol 5e-3, the scale at rtol 1e-6."""
    jb = _design(4, 13 if model == "mesh" else 11, model == "mesh", jnp.float32)
    sim, env = JSim(init_cm_time=0.0), JEnv(**FLUID_KW)
    assert jfr.supports(jb, sim, env)
    dt = jnp.asarray(j_calc_max_dt(jb)) * jnp.asarray(sim.dt_frac)
    state = j_init_state(jb)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), state)
    body = convert.body_from_numpy(_np(jb))
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)
    assert fr.supports(body, psim, penv)
    assert fr.launch_flags(body, psim, penv)["fluid_mesh"] == (model == "mesh")

    rng = np.random.default_rng(2)
    moving = batched.replace(linmom=jnp.asarray(
        rng.normal(0, 0.5, size=batched.linmom.shape).astype(np.float32))
        * jb.occ[..., None])
    thick = env.replace(aggregate_drag_coefficient=1.5e5)
    pthick = penv.replace(aggregate_drag_coefficient=1.5e5)
    ref, _ = jfr.fused_rollout(moving, jb, sim, thick, num_steps=2, dt=dt,
                               interpret=True, batch_block=2)
    out, _ = fr.fused_rollout(convert.state_from_numpy(_np(moving)), body, psim, pthick,
                              num_steps=2, dt=float(dt))
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos), rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(out.scale.numpy(), np.asarray(ref.scale), rtol=1e-6, atol=0)
    np.testing.assert_allclose(out.linmom.numpy(), np.asarray(ref.linmom),
                               rtol=1e-3, atol=5e-5)
    # the drag did act: a launch without it fails the same tolerance
    calm, _ = fr.fused_rollout(convert.state_from_numpy(_np(moving)), body, psim,
                               penv.replace(aggregate_drag_coefficient=0.0),
                               num_steps=2, dt=float(dt))
    assert not np.allclose(calm.linmom.numpy(), np.asarray(ref.linmom),
                           rtol=1e-3, atol=5e-5)

    ref, ref_stats = jfr.fused_rollout(batched, jb, sim, env, num_steps=100, dt=dt,
                                       interpret=True, batch_block=2)
    ps = convert.state_from_numpy(_np(batched))
    out, stats = fr.fused_rollout(ps, body, psim, penv, num_steps=100, dt=float(dt))
    assert float(np.abs(np.asarray(ref.linmom)).max()) > 0
    assert float(np.abs(out.pos.numpy() - np.asarray(ref.pos)).max()) <= 5e-5
    np.testing.assert_allclose(out.scale.numpy(), np.asarray(ref.scale), rtol=1e-6, atol=0)
    mass = np.asarray(jb.mass)[None, ..., None]
    cm = lambda pos: (np.asarray(pos) * mass).sum((1, 2, 3)) / mass.sum()  # noqa: E731
    start = cm(np.asarray(batched.pos))
    np.testing.assert_allclose(cm(out.pos.numpy()) - start, cm(ref.pos) - start,
                               rtol=5e-3, atol=2e-7)
    np.testing.assert_allclose(stats.time.numpy(), np.asarray(ref_stats.time), rtol=1e-6)
    assert not bool(stats.diverged.any())
    if model == "mesh":
        # the face model on the same body differs: the cheap model is not
        # what ran (tests/test_fused_rollout.py:777-784)
        face, _ = fr.fused_rollout(ps, body.replace(mesh_drag=None), psim, penv,
                                   num_steps=100, dt=float(dt))
        assert not np.allclose(face.pos.numpy(), out.pos.numpy(), atol=1e-12)


def test_supports_the_shell_rule_and_the_shared_memory_rule():
    pal = palette_from_list(evosoro_default_palette())
    rng = np.random.default_rng(0)
    structure = rng.integers(1, 5, size=(4, 4, 4)).astype(np.int32)
    sim = SimParams()
    water = EnvParams(**FLUID_KW)
    body = build_body(structure, pal)
    # the face model runs on any grid; mesh tables need the shell
    assert fr.supports(body, sim, water)
    assert not fr.supports(attach_mesh_drag(body), sim, water)
    shelled = attach_mesh_drag(build_body(np.pad(structure, ((0, 1),) * 3), pal))
    assert fr.supports(shelled, sim, water)
    # mesh tables on land are inert
    assert fr.supports(attach_mesh_drag(body), sim, EnvParams())
    assert not fr.facet_drag(fr.launch_flags(attach_mesh_drag(body), sim, EnvParams()))
    # in water the launch is refused where it is put together
    with pytest.raises(ValueError, match="empty layer"):
        fr.launch_flags(attach_mesh_drag(body), sim, water)
    for axis in range(3):  # one voxel on any far face breaks the rule
        s = np.pad(structure, ((0, 1),) * 3)
        idx = [0, 0, 0]
        idx[axis] = 4
        s[tuple(idx)] = 1
        assert not fr.supports(attach_mesh_drag(build_body(s, pal)), sim, water)
    assert fr.has_corner_shell(shelled.occ) and not fr.has_corner_shell(body.occ)
    # a fixed temperature is the fluid's own actuation; on land it still raises
    fixed = EnvParams(**FLUID_KW, vary_temp_enabled=False)
    assert fr.supports(body, sim, fixed)
    assert not fr.supports(body, sim, EnvParams(vary_temp_enabled=False))
    # limited floors stay outside
    assert not fr.supports(body, sim, EnvParams(**FLUID_KW, floor_limited=True))


def test_a_ten_cubed_swimmer_in_its_shell_is_supported_with_contact():
    """11^3 = 1331 cells with the pair pass: 43 floats a cell of shared
    memory, 228 932 of the block's 232 448 bytes; the facet drag adds none.
    One more layer does not fit in shared memory with contact: K1's
    device-memory instance runs it."""
    pal = palette_from_list(evosoro_default_palette())
    water = EnvParams(**FLUID_KW)

    def swimmer(n):
        s = np.zeros((n + 1,) * 3, dtype=np.int32)
        s[:n, :n, :n] = 3
        return attach_mesh_drag(build_body(s, pal))

    with_contact = SimParams(self_collisions_enabled=True)
    assert fr.supports(swimmer(10), with_contact, water)
    assert fr.k1_fits(11 ** 3, True)
    assert fr.k1_instance(11 ** 3, True) == "shared"
    assert fr.k1_instance(12 ** 3, True) == "device"
    assert fr.supports(swimmer(11), with_contact, water)
    assert fr.supports(swimmer(10), SimParams(), water)
    # the facet-drag bit needs the mesh tables and the fluid together
    flags = fr.launch_flags(swimmer(2), SimParams(), water, collision=False)
    assert fr._flag_bits(flags) & fr._K1_FLAG_BITS["fluid_mesh"]
    assert not fr._flag_bits(dict(flags, fluid=False)) & fr._K1_FLAG_BITS["fluid_mesh"]
