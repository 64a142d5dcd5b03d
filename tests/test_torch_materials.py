"""Voxelyze's material, solver and boundary options in the port, held
against the JAX package on the same inputs (numpy from a seed):

- the eager `sim_step` and `rollout` in float64, (i) with a bilinear and an
  MDL_DATA material, plasticity, BC regions (a pinned face with a prescribed
  displacement, a forced face, a voxel held at a prescribed orientation) and
  the max-velocity clamp, and (ii) in equilibrium mode: two steps from a
  moving state to the last bits, then an actuated rollout at the float64
  tolerances of tests/test_torch_fluid.py (metres rtol 1e-7, momenta 1e-6);
- `fused_rollout` on CPU tensors (K1's plain version) against the JAX
  Pallas kernel in interpret mode, float32, in one configuration (a kernel
  compile costs 17-35 s here): the options of (i) at once, at the JAX
  package's tolerances for these branches (tests/test_fused_rollout.py:
  381-682: pos rtol 2e-4 atol 5e-8 for the nonlinear stress, strain offset
  rtol 1e-4, linmom rtol 1e-3, the pinned layer exact) over two steps from
  a moving state, then at metric level over an actuated launch;
- `pair_contact_forces_compact_plain` and `pack_collision_compact` against
  the JAX package's `_pair_contact_forces_compact` and its table;
- every quiescence and time stop condition of `rollout` against JAX's eager
  rollout, on the passive column of tests/test_stop_conditions.py with the
  history sampled every 2 steps (HISTORY_SIZE 20 in both packages);
- `supports()` and the envelope's refusals.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_outputs import stored

import evosoro_tpu.core.types as jt
from evosoro_tpu.core.collision import build_collision_system as j_build_cs
from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.core.rollout import rollout as j_rollout
from evosoro_tpu.core.step import sim_step as j_sim_step
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.core import (
    EnvParams,
    SimParams,
    build_body,
    build_collision_system,
    evosoro_default_palette,
    init_state,
    palette_from_list,
    rollout,
    sim_step,
)
from evosoro_tpu_torch.core import types as pt
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)
jfr = importlib.import_module("evosoro_tpu.ops.fused_rollout")

METRES = dict(rtol=1e-7, atol=1e-9)
MOMENTA = dict(rtol=1e-6, atol=1e-9)
N = 4


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _palette_entries(nonlinear):
    """evosoro's palette, with a bilinear muscle (yield at 2 % strain) and
    an MDL_DATA soft tissue of 5 points when `nonlinear`."""
    entries = [dict(id=m.id, name=m.name, elastic_mod=m.elastic_mod, cte=m.cte)
               for m in evosoro_default_palette()]
    if nonlinear:
        entries[2].update(mat_model=pt.MDL_BILINEAR, yield_stress=0.02 * 5e6,
                          plastic_mod=5e5)
        entries[0].update(mat_model=pt.MDL_DATA, ss_strain=(0.0, 0.01, 0.02, 0.05, 0.1),
                          ss_stress=(0.0, 5e4, 9e4, 1.6e5, 2.2e5))
    return entries


def _design(dtype, nonlinear=True, bc=True, seed=0):
    """(JAX body, the same body in the port) of a 4^3 design: random
    materials with a muscle layer at the bottom; with `bc` its x = 0 face
    pinned at a prescribed displacement, a force on its far face and one
    voxel's rotations held at a prescribed orientation."""
    rng = np.random.default_rng(seed)
    structure = rng.integers(0, 5, size=(N, N, N)).astype(np.int32)
    structure[:, :, 0] = 3
    structure[0] = np.maximum(structure[0], 1)
    phase = rng.uniform(-1, 1, size=(N, N, N))
    kw = {}
    if bc:
        occ = structure > 0
        dof = np.zeros((N, N, N), np.int32)
        dof[0] = pt.DOF_ALL
        dof[N - 1, 1, 0] = pt.DOF_TX | pt.DOF_TY | pt.DOF_TZ
        force = np.zeros((N, N, N, 3))
        force[N - 1, ..., 2] = -0.05
        disp = np.zeros((N, N, N, 3))
        disp[0, ..., 0] = 2e-4
        tdisp = np.zeros((N, N, N, 3))
        tdisp[N - 1, 1, 0] = (0.05, -0.02, 0.1)
        kw = dict(dof_fixed=np.where(occ, dof, 0),
                  external_force=force * occ[..., None],
                  external_disp=disp * occ[..., None], external_tdisp=tdisp)
    entries = _palette_entries(nonlinear)
    jb = j_build_body(structure, j_palette([jt.Material(**e) for e in entries], dtype=dtype),
                      phase_offset=phase, dtype=dtype, **kw)
    body = build_body(structure, palette_from_list([pt.Material(**e) for e in entries]),
                      phase_offset=phase, dtype=torch.float64 if dtype == jnp.float64
                      else torch.float32, **kw)
    return jb, body


def _moving(st, jb, scale=1e-3, seed=1):
    rng = np.random.default_rng(seed)
    return st.replace(linmom=jnp.asarray(rng.normal(0, scale, size=st.linmom.shape))
                      .astype(st.linmom.dtype) * jb.occ[..., None])


CASES = {
    "materials_bc_clamp": dict(sim=dict(plasticity_enabled=True, max_velocity_enabled=True,
                                        max_vox_vel_limit=5e-4)),
    # a passive body that starts moving, free of floor and gravity: its
    # energy falls, and the mode's zeroing fires
    "equilibrium": dict(sim=dict(equilibrium_mode=True), nonlinear=False, bc=False,
                        env=dict(temp_enabled=False, gravity_enabled=False,
                                 floor_enabled=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eager_material_step_and_rollout_match_jax_in_float64(case):
    c = CASES[case]
    jb, _ = _design(jnp.float64, c.get("nonlinear", True), c.get("bc", True))
    body = convert.body_from_numpy(_np(jb), dtype=torch.float64)
    assert body.all_linear == (not c.get("nonlinear", True))
    sim = jt.SimParams(init_cm_time=0.0, **c["sim"])
    env = jt.EnvParams(**c.get("env", {}))
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)
    dt = float(j_calc_max_dt(jb)) * 0.9

    st = _moving(j_init_state(jb, dtype=jnp.float64), jb)
    s = convert.state_from_numpy(_np(st), dtype=torch.float64)
    step = jax.jit(lambda x: j_sim_step(x, jb, sim, env, dt))
    names = ("pos", "linmom", "angmom", "scale", "max_strain", "strain_offset", "ke_history")
    for _ in range(2):
        st, s = step(st), sim_step(s, body, psim, penv, dt)
    for name in names:
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(st, name)),
                                   rtol=1e-12, atol=1e-16, err_msg=name)
    if case == "equilibrium":
        # every step of 60 along JAX's trajectory at rtol 1e-12 (strains are
        # a difference of near-equal lengths over L, atol 1e-15; after a
        # zeroing the momenta are sums of forces that nearly cancel, atol
        # 1e-13): the quaternion's identity snap would part two whole
        # trajectories (ROADMAP.md section C), and the ring decides on sums
        # of energies
        atol = dict(linmom=1e-13, angmom=1e-13)
        zeroed = 0
        for _ in range(60):
            s = sim_step(convert.state_from_numpy(_np(st), dtype=torch.float64), body, psim,
                         penv, dt)
            st = step(st)
            for name in names:
                np.testing.assert_allclose(getattr(s, name).numpy(),
                                           np.asarray(getattr(st, name)),
                                           rtol=1e-12, atol=atol.get(name, 1e-15),
                                           err_msg=name)
            zeroed += float(st.ke_history[0]) == 0.0
        assert zeroed >= 2  # the zeroing fired, and more than once
        return

    steps = 60
    ref = jax.jit(lambda: j_rollout(jb, sim, env, num_steps=steps, dt=dt))()
    res = rollout(body, psim, penv, num_steps=steps, dt=dt)
    f, rf = res.final_state, ref.final_state
    np.testing.assert_allclose(f.pos.numpy(), np.asarray(rf.pos), **METRES)
    np.testing.assert_allclose(f.linmom.numpy(), np.asarray(rf.linmom), **MOMENTA)
    np.testing.assert_allclose(f.angmom.numpy(), np.asarray(rf.angmom), **MOMENTA)
    np.testing.assert_allclose(f.scale.numpy(), np.asarray(rf.scale), rtol=1e-12)
    np.testing.assert_allclose(f.ke_history.numpy(), np.asarray(rf.ke_history),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(res.norm_final_dist), float(ref.norm_final_dist),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(f.strain_offset.numpy(), np.asarray(rf.strain_offset),
                               rtol=1e-6, atol=1e-12)
    assert float(f.strain_offset.abs().max()) > 1e-4  # plasticity left an offset
    # the pinned face sits at its nominal place plus the displacement, the
    # held voxel at its prescribed orientation
    pinned = body.nom_pos[0] + body.external_disp[0]
    occ0 = body.occ[0]
    assert torch.equal(f.pos[0][occ0], pinned[occ0])
    held = f.quat[N - 1, 1, 0].numpy()
    np.testing.assert_allclose(held, np.asarray(rf.quat)[N - 1, 1, 0], rtol=1e-12)
    assert abs(held[0] - 1.0) > 1e-4
    # the clamp acted: without it the port's rollout parts from JAX's
    free = rollout(body, psim.replace(max_velocity_enabled=False), penv, num_steps=steps,
                   dt=dt).final_state
    assert float((free.pos - f.pos).abs().max()) > 1e-6


def _fused_inputs(dtype=jnp.float32):
    jb, _ = _design(dtype)
    sim = jt.SimParams(init_cm_time=0.0, plasticity_enabled=True, max_velocity_enabled=True,
                       max_vox_vel_limit=5e-4)
    env = jt.EnvParams()
    state = j_init_state(jb)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), state)
    return jb, sim, env, batched


MATERIALS_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                                 "materials_kernel_jax.npz")


def materials_kernel_case():
    """The JAX inputs of `test_fused_materials_match_jax_kernel`: (body, sim,
    env, dt, the fast-moving batch)."""
    jb, sim, env, batched = _fused_inputs()
    dt = jnp.asarray(j_calc_max_dt(jb)) * jnp.asarray(sim.dt_frac)
    return jb, sim, env, dt, _moving(batched, jb, scale=0.3)


def materials_kernel_jax() -> tuple:
    """(inputs, outputs) of the JAX kernel in interpret mode, two steps."""
    jb, sim, env, dt, moving = case = materials_kernel_case()
    ref, _ = jfr.fused_rollout(moving, jb, sim, env, num_steps=2, dt=dt,
                               interpret=True, batch_block=2)
    return case, dict(pos=ref.pos, linmom=ref.linmom, scale=ref.scale,
                      strain_offset=ref.strain_offset)


def test_fused_materials_match_jax_kernel():
    """One launch of two steps from a fast-moving state (momenta of 0.3,
    so the stress leaves the linear range, bonds go plastic and the clamp
    holds every voxel within the first step). Plasticity's offset is held
    at rtol 1e-4 with an atol of 1e-4 of its largest value (a bond that
    just left new territory carries an offset of rounding size, in which
    the two float32 paths differ by their ulps). Guards: without the clamp,
    and on the linear palette, the port parts from the kernel. The kernel's
    outputs are read from `tests/fixtures/materials_kernel_jax.npz`
    (`make_materials_kernel_jax.py`: its compile in interpret mode was most
    of this test's time) after checking that it ran on these inputs."""
    case = materials_kernel_case()
    jb, sim, env, dt, moving = case
    ref = stored(MATERIALS_FIXTURE, "kernel", *case)
    body = convert.body_from_numpy(_np(jb))
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(env)
    assert jfr.supports(jb, sim, env) and fr.supports(body, psim, penv)
    flags = fr.launch_flags(body, psim, penv)
    for k in ("nonlinear", "mdl_data", "bc", "plasticity", "max_vel"):
        assert flags[k], k

    out, _ = fr.fused_rollout(convert.state_from_numpy(_np(moving)), body, psim, penv,
                              num_steps=2, dt=float(dt))
    np.testing.assert_allclose(out.pos.numpy(), ref["pos"], rtol=2e-4, atol=5e-8)
    np.testing.assert_allclose(out.linmom.numpy(), ref["linmom"], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(out.scale.numpy(), ref["scale"], rtol=1e-6, atol=0)
    soff = ref["strain_offset"]
    np.testing.assert_allclose(out.strain_offset.numpy(), soff, rtol=1e-4,
                               atol=1e-4 * np.abs(soff).max())
    occ0 = body.occ[0]
    pinned = (body.nom_pos[0] + body.external_disp[0])[occ0]
    assert torch.equal(out.pos[:, 0][:, occ0], pinned.expand(2, -1, -1))
    np.testing.assert_array_equal(ref["pos"][:, 0][:, np.asarray(occ0)],
                                  pinned.expand(2, -1, -1).numpy())
    # the clamp acted: a launch without it parts from the kernel
    free, _ = fr.fused_rollout(convert.state_from_numpy(_np(moving)), body,
                               psim.replace(max_velocity_enabled=False), penv,
                               num_steps=2, dt=float(dt))
    assert not np.allclose(free.pos.numpy(), ref["pos"], rtol=2e-4, atol=5e-8)

    assert float(out.strain_offset.abs().max()) > 1e-3  # plasticity acted
    # the linear palette on the same design is another body
    _, lin_body = _design(jnp.float32, nonlinear=False)
    linear, _ = fr.fused_rollout(convert.state_from_numpy(_np(moving)), lin_body, psim,
                                 penv, num_steps=2, dt=float(dt))
    assert not np.allclose(linear.linmom.numpy(), ref["linmom"], rtol=1e-3, atol=1e-6)


def _contact_inputs(seed=0, n=5):
    """A random n^3 design's collision tables, and its lattice shrunk about
    its centre and jittered so far surface voxels touch."""
    rng = np.random.default_rng(seed)
    structure = rng.integers(0, 4, size=(n, n, n)).astype(np.int32)
    structure[n // 2, n // 2, :] = 1
    e = np.where(structure > 0, 5e6, 0.0)
    ix = np.stack(np.meshgrid(*(np.arange(n),) * 3, indexing="ij"), -1).reshape(-1, 3)
    nom = (ix + 0.5) * 0.01
    pos = nom.mean(0) + 0.4 * (nom - nom.mean(0)) + rng.normal(0, 5e-4, size=nom.shape)
    scale = rng.uniform(0.009, 0.011, size=n ** 3)
    return structure, e, pos.astype(np.float32), scale.astype(np.float32)


def test_compact_pair_pass_matches_jax():
    """The table carries JAX's compacted pair stiffnesses and, in place of
    its one-hot gather matrix, the surface voxels' indices; the forces equal
    JAX's `_pair_contact_forces_compact` (its one-hot products are exact at
    HIGHEST precision) to float32 rounding, and the dense pass's."""
    n = 5
    structure, e, pos, scale = _contact_inputs(n=n)
    V = n ** 3
    Vp = -(-V // 128) * 128
    jcs = j_build_cs(structure, e, 0.01)
    cs = build_collision_system(structure, e, 0.01)
    table = fr.pack_collision_compact(cs, (n, n, n))
    jtab = np.asarray(jfr.pack_collision_compact(jcs, Vp, (n, n, n)))
    S = table.shape[1]
    assert S == int(np.asarray(cs.surf_mask).sum()) < V
    np.testing.assert_array_equal(table[1:], jtab[Vp:Vp + S, :S])
    np.testing.assert_array_equal(table[0], np.argmax(jtab[:Vp, :S], axis=0))
    assert (jtab[:Vp, :S].sum(0) == 1).all()

    p = np.zeros((3, Vp), np.float32)
    p[:, :V] = pos.T
    s = np.zeros(Vp, np.float32)
    s[:V] = scale
    ref = jfr._pair_contact_forces_compact(tuple(jnp.asarray(p[c:c + 1]) for c in range(3)),
                                           jnp.asarray(s[None]), jnp.asarray(jtab), Vp,
                                           jnp.float32)
    ref = np.concatenate([np.asarray(r) for r in ref], 0)[:, :V]
    got = fr.pair_contact_forces_compact_plain(
        torch.as_tensor(pos.T[None].copy()), torch.as_tensor(scale[None]),
        torch.as_tensor(table))[0].numpy()
    fmax = np.abs(ref).max()
    assert fmax > 0 and (np.abs(ref).sum(0) > 0).sum() > 10
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * fmax)
    dense = fr.pair_contact_forces_plain(
        torch.as_tensor(pos.T[None].copy()), torch.as_tensor(scale[None]),
        torch.as_tensor(fr.pack_collision(cs, (n, n, n))[None]))[0].numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5 * fmax)
    # a batch of tables, one per robot
    two = fr.pair_contact_forces_compact_plain(
        torch.as_tensor(np.stack([pos.T, pos.T])), torch.as_tensor(np.stack([scale, scale])),
        torch.as_tensor(np.stack([table, table])))
    assert torch.equal(two[0], two[1]) and torch.equal(two[0], torch.as_tensor(got))


SC_CASES = {
    "max_time_steps": (jt.SC_MAX_TIME_STEPS, 5.0, {}),
    "temp_cycles": (jt.SC_TEMP_CYCLES, 2.0, dict(temp_enabled=True, temp_period=2e-4)),
    "const_maxenergy": (jt.SC_CONST_MAXENERGY, 1e3, {}),
    "min_ke": (jt.SC_MIN_KE, 1e3, {}),
    "min_maxmove": (jt.SC_MIN_MAXMOVE, 1e3, {}),
    "min_maxmove_max_sim_time": (jt.SC_MIN_MAXMOVE_MAX_SIM_TIME, 2e-3, {}),
}


@pytest.mark.parametrize("case", list(SC_CASES))
def test_stop_conditions_match_jax_eager_rollout(case, monkeypatch):
    """Each condition is met inside the 40 steps, and the frozen state (time
    included) equals JAX's."""
    sc, value, env_kw = SC_CASES[case]
    monkeypatch.setattr(jt, "HISTORY_SIZE", 20)
    monkeypatch.setattr(pt, "HISTORY_SIZE", 20)
    structure = np.ones((1, 1, 2), np.int32)
    jb = j_build_body(structure, j_palette(jt.evosoro_default_palette(), dtype=jnp.float64),
                      dtype=jnp.float64)
    body = convert.body_from_numpy(_np(jb), dtype=torch.float64)
    sim = jt.SimParams(stop_condition_value=value, init_cm_time=0.0)
    env = jt.EnvParams(**dict(dict(temp_enabled=False), **env_kw))
    dt = float(j_calc_max_dt(jb)) * 0.9
    ref = jax.jit(lambda: j_rollout(jb, sim, env, num_steps=40, dt=dt,
                                    stop_condition_type=sc))()
    res = rollout(body, convert.sim_params_from_jax(sim), convert.env_params_from_jax(env),
                  num_steps=40, dt=dt, stop_condition_type=sc)
    t = float(res.final_state.time)
    assert t < 39.5 * dt  # it stopped
    np.testing.assert_allclose(t, float(ref.final_state.time), rtol=1e-12)
    np.testing.assert_allclose(float(res.lifetime), float(ref.lifetime), rtol=1e-12)
    np.testing.assert_allclose(res.final_state.pos.numpy(), np.asarray(ref.final_state.pos),
                               rtol=1e-12, atol=1e-16)


def test_supports_the_new_options_and_refuses_what_stays_outside():
    _, body = _design(jnp.float32)
    for sim in (SimParams(plasticity_enabled=True), SimParams(max_velocity_enabled=True),
                SimParams(equilibrium_mode=True), SimParams(self_collisions_enabled=True)):
        assert fr.supports(body, sim, EnvParams())
    flags = fr.launch_flags(body, SimParams(), EnvParams())
    assert flags["nonlinear"] and flags["mdl_data"] and flags["bc"]
    # equilibrium mode turns the clamp off, as the reference's override
    bits = fr._flag_bits(dict(flags, equilibrium=True, max_vel=True))
    assert bits & fr._K1_FLAG_BITS["equilibrium"] and not bits & fr._K1_FLAG_BITS["max_vel"]
    # volume effects run in the material instance, on land and in water,
    # and need the state's coupling carry
    vol = SimParams(volume_effects_enabled=True)
    assert fr.supports(body, vol, EnvParams())
    assert fr.launch_flags(body, vol, EnvParams())["volume"] and "volume" in fr._K1_MAT_FLAGS
    fr.check_envelope({"volume": True, "fluid": True}, {})
    with pytest.raises(ValueError, match="coupling carry"):
        sim_step(init_state(body), body, vol, EnvParams(), 1e-5)
    # the material instance runs in every variant; ballistic development in
    # water and a fixed temperature on land stay outside, by name
    water = EnvParams(fluid_environment=True, gravity_enabled=False, floor_enabled=False)
    assert fr.supports(body, SimParams(), water)
    for k in fr._K1_MAT_FLAGS:
        fr.check_envelope({k: True, "use_final_size": True}, {})
        with pytest.raises(NotImplementedError, match="ballistic"):
            fr.check_envelope({k: True, "fluid": True, "use_final_size": True,
                               "ballistic": True}, {})
        with pytest.raises(NotImplementedError, match="fixed"):
            fr.check_envelope({k: True, "temp_enabled": True}, {})
    # a stop condition other than max sim time on the fused path
    state = init_state(body)
    batched = state.replace(**{f: getattr(state, f)[None] for f in (
        "pos", "quat", "linmom", "angmom", "scale", "last_scale", "small_angle",
        "last_pos2", "last_angle1", "last_angle2", "max_strain", "strain_offset", "time",
        "diverged", "ke_history")})
    with pytest.raises(NotImplementedError, match="stop condition"):
        fr.fused_rollout(batched, body, SimParams(), EnvParams(), 1, 1e-5,
                         stop_condition_type=pt.SC_MIN_KE)
    # B4 refuses every option of the material instance but the two its own
    # material instance differentiates on land
    for k in fr._K1_MAT_FLAGS:
        assert fr.diff_envelope_ok({k: True}, {}) == (k in ("nonlinear", "max_vel"))


def test_the_compact_switch_and_the_shared_memory_it_frees(monkeypatch):
    """`EVOSORO_TPU_COLL_COMPACT=1` runs the compact pass whenever the
    surface has fewer voxels than the grid (S < V); the pair pass's staging
    and tables then count S entries in place of V."""
    _, body = _design(jnp.float32, nonlinear=False, bc=False)
    occ = body.occ.numpy()
    cs = build_collision_system(body.mat.numpy(), body.e_mod.numpy(), 0.01)
    body = body.replace(collision=cs)
    sim = SimParams(self_collisions_enabled=True, init_cm_time=0.0)
    state = init_state(body)
    batched = state.replace(**{f: getattr(state, f)[None] for f in (
        "pos", "quat", "linmom", "angmom", "scale", "last_scale", "small_angle",
        "last_pos2", "last_angle1", "last_angle2", "max_strain", "strain_offset", "time",
        "diverged", "ke_history")})
    dt = 1e-4
    seen = []
    real = fr.fused_call

    def spy(*a, **k):
        seen.append((k["flags"].get("collision_compact"), tuple(a[3].shape)))
        return real(*a, **k)

    monkeypatch.setattr(fr, "fused_call", spy)
    dense, _ = fr.fused_rollout(batched, body, sim, EnvParams(), 5, dt)
    monkeypatch.setenv("EVOSORO_TPU_COLL_COMPACT", "1")
    compact, _ = fr.fused_rollout(batched, body, sim, EnvParams(), 5, dt)
    S = int(np.asarray(cs.surf_mask).sum())
    assert S < occ.size
    assert seen == [(False, (1, N ** 3, N ** 3)), (True, (1, S + 1, S))]
    torch.testing.assert_close(compact.pos, dense.pos, rtol=2e-5, atol=1e-9)
    assert fr.k1_fits(1339, True) and not fr.k1_fits(1340, True)
    assert fr.k1_fits(1400, True, n_surf=700) and not fr.k1_fits(1400, True)
    assert not fr.k1_fits(1400, True, n_surf=1400)
    # 39 floats a cell, then 32-entry groups of S entries: 128 floats of
    # staging, 9 of box and active bits and a mask word a group
    assert fr.k1_buffer_floats(1000, True, n_surf=488) == 39 * 1000 + 16 * (128 + 9 + 1)
    assert fr.k1_buffer_floats(1400, True, n_surf=700) == 39 * 1400 + 22 * (128 + 9 + 1)
    assert fr.k1_buffer_floats(1000, True) == 39 * 1000 + 32 * (128 + 9 + 1)
