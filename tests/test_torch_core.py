"""The port's core (`evosoro_tpu_torch.core`) held against the JAX package.

Inputs are made with numpy from a seed and go through both packages; JAX
references are built in float32 explicitly (conftest turns x64 on) and the
data is carried across with `evosoro_tpu_torch.convert`. Tolerances are the
JAX package's own kernel-vs-jnp bounds (tests/test_fused_rollout.py:63-78).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.core import quaternion as jq
from evosoro_tpu.core.collision import attach_collision_system
from evosoro_tpu.core.collision import build_collision_system as j_build_cs
from evosoro_tpu.core.collision import collision_forces as j_collision_forces
from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.core.rollout import num_steps_for as j_num_steps_for
from evosoro_tpu.core.step import sim_step as j_sim_step
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.core import (
    build_body,
    build_collision_system,
    calc_max_dt,
    collision_forces,
    evosoro_default_palette,
    num_steps_for,
    palette_from_list,
    sim_step,
)
from evosoro_tpu_torch.core import quaternion as pq

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TOL = dict(pos=(2e-5, 1e-9), quat=(2e-5, 1e-7), linmom=(1e-4, 1e-10),
           scale=(1e-6, 0.0), time=(1e-6, 0.0))


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _random_design(n, seed, empty=True):
    rng = np.random.default_rng(seed)
    structure = rng.integers(0 if empty else 1, 5, size=(n, n, n)).astype(np.int32)
    structure[n // 2, n // 2, 0] = 3
    return structure, rng.uniform(-1, 1, size=(n, n, n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_body_matches_jax(seed):
    structure, phase = _random_design(5, seed)
    jb = _np(j_build_body(structure, j_palette(j_default_palette()),
                          phase_offset=phase, dtype=jnp.float32))
    pb = build_body(structure, palette_from_list(evosoro_default_palette()),
                    phase_offset=phase)
    for f in dataclasses.fields(pb):
        a, b = getattr(pb, f.name), getattr(jb, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        if not torch.is_tensor(a):
            assert float(a) == float(np.asarray(b)), f.name
            continue
        b = np.asarray(b)
        assert a.shape == b.shape, f.name
        np.testing.assert_array_equal(a.numpy().astype(b.dtype), b, err_msg=f.name)
    dt_j = float(j_calc_max_dt(j_build_body(
        structure, j_palette(j_default_palette()), dtype=jnp.float32)))
    np.testing.assert_allclose(float(calc_max_dt(pb)), dt_j, rtol=1e-7)
    sim = JSim(stop_condition_value=0.05)
    assert num_steps_for(pb, convert.sim_params_from_jax(sim)) == j_num_steps_for(
        j_build_body(structure, j_palette(j_default_palette()), dtype=jnp.float32),
        sim)


def _quat_inputs(n=512, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[: n // 4, 1:] *= 1e-3  # near-identity: the small-angle fast paths
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v[: n // 4, 1:] *= 1e-3  # nearly along +X
    return q, rng.normal(size=(n, 4)).astype(np.float32), v


@pytest.mark.parametrize("fn", [
    "quat_multiply", "quat_conjugate", "quat_rotate", "quat_rotate_inv",
    "quat_normalize_fast", "quat_from_rotation_vector",
    "quat_to_rotation_vector", "quat_from_angle_to_pos_x",
    "quat_is_small_angle", "quat_is_smallish_angle"])
def test_quaternion_matches_jax(fn):
    q, q2, v = _quat_inputs()
    args = {"quat_multiply": (q, q2), "quat_conjugate": (q,),
            "quat_rotate": (q, v), "quat_rotate_inv": (q, v),
            "quat_normalize_fast": (q2,), "quat_from_rotation_vector": (v,),
            "quat_to_rotation_vector": (q,), "quat_from_angle_to_pos_x": (v,),
            "quat_is_small_angle": (q,), "quat_is_smallish_angle": (q,)}[fn]
    ref = np.asarray(getattr(jq, fn)(*[jnp.asarray(a) for a in args]))
    out = getattr(pq, fn)(*[torch.as_tensor(a) for a in args]).numpy()
    if ref.dtype == np.bool_:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-6, atol=1e-7)


def test_collision_matches_jax():
    structure, phase = _random_design(5, 4)
    e = np.asarray(j_palette(j_default_palette()).elastic_mod)[structure]
    cs_j = j_build_cs(structure, e, 0.01)
    cs_p = build_collision_system(structure, e, 0.01)
    for f in ("surf_idx", "surf_mask", "pair_a1", "allowed"):
        np.testing.assert_array_equal(getattr(cs_p, f), np.asarray(getattr(cs_j, f)))
    # squeeze the design about its centre so distant surface voxels touch
    rng = np.random.default_rng(4)
    nom = (np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"), -1) + 0.5) * 0.01
    pos = (0.025 + 0.6 * (nom - 0.025) + rng.normal(0, 3e-4, nom.shape)).astype(np.float32)
    scale = np.full((5, 5, 5), 0.01, np.float32)
    f_j = np.asarray(j_collision_forces(jnp.asarray(pos), jnp.asarray(scale), cs_j))
    f_p = collision_forces(torch.as_tensor(pos), torch.as_tensor(scale),
                           convert.collision_from_numpy(cs_j)).numpy()
    assert np.abs(f_j).max() > 0
    np.testing.assert_allclose(f_p, f_j, rtol=1e-5, atol=1e-5 * np.abs(f_j).max())


def _contact_event_design():
    """A free voxel launched at a bonded pair inside a 5³ grid, with gravity,
    floor and actuation off: the contact acts within 25 steps while the
    motion stays smooth (tests/test_fused_rollout.py:201-247 in 5³)."""
    structure = np.zeros((5, 5, 5), np.int32)
    structure[:2, 2, 2] = 1
    structure[3, 2, 2] = 1
    return structure


_CONFIGS = ("default", "sticky", "collision", "limited")
# the limited floor's radius for the 5^3 design: the voxel centres lie 0,
# 1, 1.41, 2, 2.24 or 2.83 lattice units from the floor's centre, so the
# outer ring starts off the floor and no centre lies within 0.2 units of
# its edge (where an ulp would flip contact). It runs in float32 as its
# siblings do: a voxel resting on the floor starts at penetration 0 exactly,
# and in float64 the step at which contact sets in is decided by the last
# bit (XLA contracts FMA, eager torch does not), which parts the two
# packages' momenta by 5e-7 at step 3 with or without the limit
LIMITED_RADIUS = 0.018


def _setup(config):
    if config == "collision":
        structure = _contact_event_design()
        jb = j_build_body(structure, j_palette(j_default_palette()),
                          dtype=jnp.float32)
        jb = attach_collision_system(jb)
        sim = JSim(self_collisions_enabled=True)
        env = JEnv(gravity_enabled=False, floor_enabled=False, temp_enabled=False)
    else:
        structure, phase = _random_design(5, 0)
        jb = j_build_body(structure, j_palette(j_default_palette()),
                          phase_offset=phase, dtype=jnp.float32)
        sim = JSim()
        env = JEnv(sticky_floor=config == "sticky", floor_limited=config == "limited",
                   floor_radius=LIMITED_RADIUS if config == "limited" else 0.0)
    dt = jnp.asarray(j_calc_max_dt(jb), jnp.float32) * jnp.asarray(sim.dt_frac, jnp.float32)
    state = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (2,) + x.shape), j_init_state(jb, dtype=jnp.float32))
    if config == "collision":
        # launch the free voxel at the pair (contact below a 0.015 m gap)
        lin = np.array(state.linmom)
        lin[:, 3, 2, 2, 0] = -2.0 * float(jb.mass[3, 2, 2]) * np.array([1.0, 0.7])
        state = state.replace(linmom=jnp.asarray(lin))
    return jb, sim, env, dt, state


@pytest.fixture(scope="module")
def jax_trajectories():
    """Per config: the JAX states after 1 and 25 steps (one compile each)."""
    out = {}
    for config in _CONFIGS:
        jb, sim, env, dt, state = _setup(config)

        def run(s, jb=jb, sim=sim, env=env, dt=dt):
            def f(s, i):
                s = j_sim_step(s, jb, sim, env, dt)
                return s, s

            _, traj = jax.lax.scan(f, s, jnp.arange(25))
            return traj

        traj = jax.jit(jax.vmap(run))(state)
        out[config] = (jb, sim, env, dt, state, _np(traj))
    return out


@pytest.mark.parametrize("steps", [1, 25])
@pytest.mark.parametrize("config", _CONFIGS)
def test_sim_step_matches_jax(jax_trajectories, config, steps):
    jb, sim, env, dt, state, traj = jax_trajectories[config]
    body = convert.body_from_numpy(_np(jb))
    s = convert.state_from_numpy(_np(state))
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)
    for _ in range(steps):
        s = sim_step(s, body, psim, penv, float(dt))
    ref = jax.tree_util.tree_map(lambda a: a[:, steps - 1], traj)
    for name in ("pos", "quat", "linmom", "scale", "time"):
        rtol, atol = TOL[name]
        np.testing.assert_allclose(getattr(s, name).numpy(), getattr(ref, name),
                                   rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_array_equal(s.small_angle.numpy(), ref.small_angle)
    assert not s.diverged.any()
    if config == "collision" and steps == 25:
        assert float(ref.linmom[0, 3, 2, 2, 0]) > 0.0  # the voxel bounced
    if config == "limited" and steps == 25:
        # the floor holds the voxels over it and lets the outer ring sink
        z = ref.pos[0, ..., 2]
        occ = np.asarray(jb.occ)
        assert z[1:4, 1:4, 0][occ[1:4, 1:4, 0]].min() > z[[0, 4]][:, :, 0][
            occ[[0, 4]][:, :, 0]].min()


def test_sim_step_refuses_features_outside_envelope():
    structure, phase = _random_design(4, 0)
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=phase)
    from evosoro_tpu_torch.core import EnvParams, SimParams, init_state

    state = init_state(body)
    # the limited floor steps
    limited = sim_step(state, body, SimParams(),
                       EnvParams(floor_limited=True, floor_radius=0.015), 1e-5)
    assert bool(torch.isfinite(limited.pos).all())
    # volume effects need the state's coupling carry, and run with it
    vol = SimParams(volume_effects_enabled=True)
    with pytest.raises(ValueError, match="coupling carry"):
        sim_step(state, body, vol, EnvParams(), 1e-5)
    stepped = sim_step(init_state(body, volume_effects=True), body, vol, EnvParams(), 1e-5)
    assert bool(torch.isfinite(stepped.pos).all()) and float(stepped.cur_dt) > 0
    # dt reduction across shards is applied where the JAX package applies it
    # (evosoro_tpu/core/step.py:844-847): to the largest bond frequency the
    # volume-effects dt is taken from; without volume effects it is not called
    seen = []
    doubled = sim_step(init_state(body, volume_effects=True), body, vol, EnvParams(), 1e-5,
                       dt_reduce=lambda f: seen.append(f) or 2 * f)
    assert len(seen) == 1
    torch.testing.assert_close(doubled.cur_dt, stepped.cur_dt / 2, rtol=1e-6, atol=0)
    sim_step(state, body, SimParams(), EnvParams(), 1e-5, dt_reduce=seen.append)
    assert len(seen) == 1
    # a fluid environment, development fields, plasticity, the max-velocity
    # clamp and equilibrium mode are inside the envelope
    fluid = sim_step(state, body, SimParams(), EnvParams(fluid_environment=True), 1e-5)
    assert bool(torch.isfinite(fluid.pos).all())
    for sim in (SimParams(plasticity_enabled=True), SimParams(max_velocity_enabled=True),
                SimParams(equilibrium_mode=True)):
        assert bool(torch.isfinite(sim_step(state, body, sim, EnvParams(), 1e-5).pos).all())


def test_import_leaves_jax_out():
    code = ("import sys, evosoro_tpu_torch, evosoro_tpu_torch.evo.algorithms, "
            "evosoro_tpu_torch.bench, evosoro_tpu_torch.convert, "
            "evosoro_tpu_torch.control, evosoro_tpu_torch.control.shooting, "
            "evosoro_tpu_torch.control.sqp, evosoro_tpu_torch.ops.fused_diff, "
            "evosoro_tpu_torch.roofline, evosoro_tpu_torch.device, "
            "evosoro_tpu_torch.envs, evosoro_tpu_torch.envs.drag, "
            "evosoro_tpu_torch.envs.sources, evosoro_tpu_torch.envs.regions, "
            "evosoro_tpu_torch.io, evosoro_tpu_torch.io.vxa, "
            "evosoro_tpu_torch.native, evosoro_tpu_torch.core.shape, "
            "evosoro_tpu_torch.io.mesh_io, evosoro_tpu_torch.viz.marching, "
            "evosoro_tpu_torch.parallel.mesh, evosoro_tpu_torch.parallel.spatial, "
            "evosoro_tpu_torch.parallel.ranks, evosoro_tpu_torch.graft_entry, "
            "evosoro_tpu_torch.analysis, evosoro_tpu_torch.analysis.fea, "
            "evosoro_tpu_torch.analysis.tensile, evosoro_tpu_torch.viz, "
            "evosoro_tpu_torch.viz.render, evosoro_tpu_torch.viz.trajectory, "
            "evosoro_tpu_torch.viz.sandbox, evosoro_tpu_torch.onchip_parity; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'evosoro_tpu', 'matplotlib')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_vxa_build_body_needs_the_card_unless_cpu_is_asked():
    """`VXADocument.build_body()` with no device goes through
    `device.resolve_device`, as the other entry points: the card, and
    without one it raises."""
    from evosoro_tpu_torch.io.vxa import load_vxa

    path = next((REPO / "basic_data" / "bestSoFar" / "fitOnly").glob("*.vxa"))
    doc = load_vxa(str(path))
    assert doc.build_body(device="cpu").occ.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        doc.build_body()
