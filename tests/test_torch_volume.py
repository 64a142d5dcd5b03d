"""Volume effects (Voxelyze's VolumeEffectsEnabled) in the port, held
against the JAX package on the same inputs, made with numpy from a seed:
the Poisson-coupled bond stress with its thermal term, the dt recomputed
after every bond pass and the voxel pass's transverse coupling
(VXS_BondInternal.cpp:200-298, VXS_Voxel.cpp:543-632, VX_Sim.cpp:1792).

- The eager `sim_step` and `rollout` in float64 on the JAX package's volume
  parity design (tools/onchip_parity.py `_scenario_volume`: 4^3, materials
  1-4, actuation from time 0 under a temperature amplitude of 10): three
  steps chained, to the last bits, before any quaternion snaps to the
  identity (ROADMAP.md section C); then 40 steps each from JAX's state,
  every carried field at float64 rounding; then NormFinalDist of an
  80-step rollout at rtol 5e-3, as the port's other files hold metrics past
  the actuation onset. And two different robots in one batch, each with
  its own recomputed dt.
- `fused_rollout` on CPU tensors (the plain version of K1's volume
  instance) against the JAX Pallas kernel in interpret mode, float32, 8
  robots over 80 steps, at the tolerances of tests/test_fused_rollout.py:
  284-327 (the JAX kernel against its jnp step): pos rtol 2e-4 atol 2e-8,
  scale rtol 1e-5, the side means of the transverse sums rtol 2e-3 atol
  1e-6 and of the sections rtol 1e-4, the stats row's dt and time rtol
  1e-6. The port's pow is the JAX kernel's exp(-mu log(.)): that difference
  rides inside these tolerances.
- The `.cu` built for the host by g++ (`emu_fwd_vol`) against the plain
  version on the same packed tensors, with a BC-constrained axis and
  contact on, and with the features.
- The entry points, the control entry points' carry, the evaluator's step
  counts and re-dispatch, the `.vxa` round trip and replay, `convert`.
"""

import ctypes
import dataclasses
import importlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_outputs import stored
from test_torch_b4_host import host_lib  # noqa: F401
from test_torch_evaluation import _population

import evosoro_tpu.core.types as jt
from evosoro_tpu.control.sqp import FusedSQPSolver as JFusedSQPSolver
from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.core.rollout import rollout as j_rollout
from evosoro_tpu.core.step import sim_step as j_sim_step
from evosoro_tpu.evo import base as j_base
from evosoro_tpu.evo import evaluation as j_evaluation
from evosoro_tpu.evo.networks import CPPN as JCPPN
from evosoro_tpu.evo.softbot import Genotype as JGenotype
from evosoro_tpu.evo.softbot import Phenotype as JPhenotype
from evosoro_tpu.evo.softbot import Population as JPopulation
from evosoro_tpu.io.vxa import load_vxa as j_load_vxa
from evosoro_tpu.utils.phenotype_mappers import make_material_tree as j_material_tree
from evosoro_tpu_torch import bench, convert
from evosoro_tpu_torch.control import CEMConfig, cem_optimize, cem_optimize_fused
from evosoro_tpu_torch.control.sqp import FusedSQPSolver
from evosoro_tpu_torch.core import (
    calc_max_dt,
    init_state,
    num_steps_for,
    rollout,
    sim_step,
)
from evosoro_tpu_torch.core.rollout import relaunch_until_stop
from evosoro_tpu_torch.core.types import SimState, VoxelBody
from evosoro_tpu_torch.evo import base, evaluation
from evosoro_tpu_torch.evo.base import Env, ObjectiveDict, Sim
from evosoro_tpu_torch.evo.networks import CPPN
from evosoro_tpu_torch.evo.softbot import Genotype, Phenotype, Population
from evosoro_tpu_torch.io.vxa import load_vxa
from evosoro_tpu_torch.ops import fused_rollout as fr
from evosoro_tpu_torch.utils.phenotype_mappers import make_material_tree

torch.set_num_threads(1)
jfr = importlib.import_module("evosoro_tpu.ops.fused_rollout")
N = 4
SIM = jt.SimParams(volume_effects_enabled=True, init_cm_time=0.0)
ENV = jt.EnvParams(temp_amplitude=10.0)
CARRIED = ("pos", "scale", "ts_sum", "cs_area", "cur_dt", "time")


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _design(dtype, seed=0, soft=False):
    """The JAX body of the volume parity design; `soft` swaps the bone
    (material 2, 100 times stiffer) for the soft tissue, so the body's
    stiffest bond, and so its dt, is another one."""
    rng = np.random.default_rng(seed)
    structure = rng.integers(1, 5, size=(N, N, N)).astype(np.int32)
    if soft:
        structure[structure == 2] = 1
    phase = rng.uniform(-1, 1, size=(N, N, N))
    return j_build_body(structure, j_palette(jt.evosoro_default_palette(), dtype=dtype),
                        phase_offset=phase, dtype=dtype)


def _assert_close(s, st, names, rtol=1e-12, atol=None):
    atol = atol or {}
    for name in names:
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(st, name)),
                                   rtol=rtol, atol=atol.get(name, 1e-16), err_msg=name)


def _stack(items, cls):
    """A batch of port dataclasses (bodies or states) of one shape."""
    out = {}
    for f in dataclasses.fields(cls):
        vals = [getattr(x, f.name) for x in items]
        if torch.is_tensor(vals[0]):
            out[f.name] = torch.stack(vals)
        else:
            assert all(v == vals[0] for v in vals), f.name
            out[f.name] = vals[0]
    return cls(**out)


def test_eager_volume_step_and_rollout_match_jax_in_float64():
    jb = _design(jnp.float64)
    body = convert.body_from_numpy(_np(jb), dtype=torch.float64)
    psim, penv = convert.sim_params_from_jax(SIM), convert.env_params_from_jax(ENV)
    dt = float(j_calc_max_dt(jb, True)) * SIM.dt_frac
    np.testing.assert_allclose(float(calc_max_dt(body, True)), float(j_calc_max_dt(jb, True)),
                               rtol=1e-15)
    st = j_init_state(jb, dtype=jnp.float64, volume_effects=True)
    s = init_state(body, dtype=torch.float64, volume_effects=True)
    _assert_close(s, st, ("ts_sum", "cs_area", "cur_dt"), rtol=0.0, atol={})
    step = jax.jit(lambda x: j_sim_step(x, jb, SIM, ENV, dt))
    for _ in range(3):
        st, s = step(st), sim_step(s, body, psim, penv, dt)
        _assert_close(s, st, CARRIED + ("linmom", "angmom", "quat"))
    # each step from JAX's state: strains are differences of near-equal
    # lengths over L (ts atol 1e-14), the momenta sums of forces that nearly
    # cancel, which XLA contracts into FMA and eager torch does not
    atol = dict(ts_sum=1e-14, linmom=1e-10, angmom=1e-12, pos=1e-15, cs_area=1e-18)
    for _ in range(40):
        s = sim_step(convert.state_from_numpy(_np(st), dtype=torch.float64), body, psim,
                     penv, dt)
        st = step(st)
        _assert_close(s, st, CARRIED + ("linmom", "angmom"), atol=atol)
    assert float(s.ts_sum.abs().max()) > 1e-5  # the coupling acts
    assert abs(float(s.cur_dt) - dt) > 1e-6 * dt  # the dt was recomputed

    steps = 80
    ref = jax.jit(lambda: j_rollout(jb, SIM, ENV, num_steps=steps, dt=dt))()
    res = rollout(body, psim, penv, num_steps=steps, dt=dt)
    assert not bool(res.diverged) and float(res.norm_final_dist) > 1e-6
    np.testing.assert_allclose(float(res.norm_final_dist), float(ref.norm_final_dist),
                               rtol=5e-3)
    np.testing.assert_allclose(float(res.final_state.time), float(ref.final_state.time),
                               rtol=1e-6)


def test_batched_volume_step_takes_each_robots_own_dt():
    """Two robots of different bodies in one batch: the dt is a maximum over
    each robot's own bonds (JAX's `jnp.max` runs per robot under `vmap`)."""
    jbs = [_design(jnp.float64, seed=0), _design(jnp.float64, seed=1, soft=True)]
    body = _stack([convert.body_from_numpy(_np(b), dtype=torch.float64) for b in jbs],
                  VoxelBody)
    psim, penv = convert.sim_params_from_jax(SIM), convert.env_params_from_jax(ENV)
    dt = float(j_calc_max_dt(jbs[0], True)) * SIM.dt_frac
    sts = [j_init_state(b, dtype=jnp.float64, volume_effects=True) for b in jbs]
    steps = [jax.jit(lambda x, b=b: j_sim_step(x, b, SIM, ENV, dt)) for b in jbs]
    for _ in range(20):
        s = _stack([convert.state_from_numpy(_np(st), dtype=torch.float64) for st in sts],
                   SimState)
        s = sim_step(s, body, psim, penv, dt)
        sts = [f(st) for f, st in zip(steps, sts)]
        for k, st in enumerate(sts):
            for name in ("pos", "ts_sum", "cs_area", "cur_dt", "time"):
                np.testing.assert_allclose(getattr(s, name)[k].numpy(),
                                           np.asarray(getattr(st, name)), rtol=1e-12,
                                           atol=1e-14 if name == "ts_sum" else 1e-16,
                                           err_msg=name)
    assert s.cur_dt.shape == (2,) and float(s.cur_dt[0]) < 0.5 * float(s.cur_dt[1])


VOLUME_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                              "volume_kernel_jax.npz")
KERNEL_B, KERNEL_STEPS = 8, 80


def volume_kernel_case():
    """The JAX inputs of `test_fused_volume_matches_jax_kernel`: (body, dt,
    the batch of 8 at rest with the coupling carry)."""
    jb = _design(jnp.float32)
    dt = float(jnp.asarray(j_calc_max_dt(jb, True)) * jnp.asarray(SIM.dt_frac))
    jstate = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (KERNEL_B,) + x.shape),
                                    j_init_state(jb, volume_effects=True))
    return jb, dt, jstate


def volume_kernel_jax() -> tuple:
    """(inputs, outputs) of the JAX kernel in interpret mode, 80 steps."""
    jb, dt, jstate = case = volume_kernel_case()
    flags = dict(jfr.kernel_env_flags(SIM, ENV), nonlinear=False, mdl_data=False, bc=False,
                 collision=False, fluid_mesh=False, use_init_size=False, use_final_size=False,
                 use_growth_t=False, use_final_phase=False, use_final_ad=False,
                 ballistic=False)
    ref, ref_stats = jfr._fused_call(
        jfr.pack_state(jstate, 128), jfr.pack_body(jb, 128),
        jfr.make_stats(jb, KERNEL_B, dt, SIM, ENV, None, jnp.float32), None, None, None, None,
        num_steps=KERNEL_STEPS, grid_shape=(N, N, N), batch_block=8, n_knots=0,
        interpret=True, scalars=tuple(sorted(jfr.kernel_scalars(jb.nominal_size, SIM,
                                                                 ENV).items())),
        flags=tuple(sorted(flags.items())), prec=jfr.DEFAULT_PRECISION)
    return case, dict(state=np.asarray(ref)[:, :, :N ** 3], stats=np.asarray(ref_stats))


def staggered_case():
    """The JAX inputs of `test_fused_volume_staggered_stops_match_jax_kernel`:
    (body, dt, sim, stop times, stats rows, batch of 8)."""
    B, steps = 8, 40
    jb = _design(jnp.float32)
    dt = float(jnp.asarray(j_calc_max_dt(jb, True)) * jnp.asarray(SIM.dt_frac))
    sim = SIM.replace(init_cm_time=3 * dt, stop_condition_value=steps * dt)
    stops = dt * (4.5 + 4 * np.arange(B))
    jstats = jfr.make_stats(jb, B, dt, sim, ENV, None, jnp.float32)
    jstats = jstats.at[:, jfr._S_STOP].set(jnp.asarray(stops, jnp.float32))
    jstate = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                                    j_init_state(jb, volume_effects=True))
    return jb, dt, sim, stops, jstats, jstate


def staggered_jax() -> tuple:
    """(inputs, outputs) of the JAX fused rollout in interpret mode, 40 steps
    with a stop time per robot."""
    jb, dt, sim, stops, jstats, jstate = case = staggered_case()
    j_out, js = jfr.fused_rollout(jstate, jb, sim, ENV, num_steps=40, dt=dt,
                                  interpret=True, stats=jstats)
    return case, dict(time=js.time, cm_captured=js.cm_captured, diverged=js.diverged,
                      ini_cm=js.ini_cm, pos=j_out.pos, ts_sum=j_out.ts_sum,
                      cs_area=j_out.cs_area)


def test_fused_volume_matches_jax_kernel():
    """The volume instance's plain version against the JAX kernel in
    interpret mode, 8 x 4^3 x 80 steps, read from
    `tests/fixtures/volume_kernel_jax.npz` (`make_volume_kernel_jax.py`:
    the kernel's compile was most of this test's time) after checking that
    it ran on these inputs."""
    B, steps, V = KERNEL_B, KERNEL_STEPS, N ** 3
    case = volume_kernel_case()
    jb, dt, jstate = case
    stored_out = stored(VOLUME_FIXTURE, "kernel", *case)
    ref, ref_stats = stored_out["state"], stored_out["stats"]
    body = convert.body_from_numpy(_np(jb))
    psim, penv = convert.sim_params_from_jax(SIM), convert.env_params_from_jax(ENV)
    assert jfr.supports(jb, SIM, ENV) and fr.supports(body, psim, penv)

    state = convert.state_from_numpy(_np(jstate))
    pflags = fr.launch_flags(body, psim, penv, collision=False)
    assert pflags["volume"]
    out, stats = fr.fused_call(
        fr.pack_state(state), fr.pack_body(body), fr.make_stats(body, B, dt, psim, penv),
        num_steps=steps, grid_shape=(N, N, N),
        scalars=fr.kernel_scalars(body.nominal_size, psim, penv), flags=pflags)
    out, stats = out.numpy(), stats.numpy()
    for name, (a, b), rtol, atol in (("pos", (0, 3), 2e-4, 2e-8), ("scale", (13, 14), 1e-5, 0),
                                     ("ts", (47, 50), 2e-3, 1e-6), ("cs", (50, 53), 1e-4, 0)):
        np.testing.assert_allclose(out[:, a:b], ref[:, a:b], rtol=rtol, atol=atol,
                                   err_msg=name)
    for k in (fr._S_DT, fr._S_TIME):
        np.testing.assert_allclose(stats[:, k], ref_stats[:, k], rtol=1e-6)
    assert not stats[:, fr._S_DIV].any() and not ref_stats[:, jfr._S_DIV].any()
    assert np.abs(ref[:, 47:50]).max() > 1e-5  # the coupling acts
    assert abs(stats[0, fr._S_DT] - dt) > 1e-6 * dt  # the dt was recomputed
    # the launch's state and dt come back as the eager step's carry
    new, outs = fr.fused_rollout(state, body, psim, penv, steps, dt)
    np.testing.assert_array_equal(new.cur_dt.numpy(), stats[:, fr._S_DT])
    np.testing.assert_array_equal(new.ts_sum[:, 0].numpy(), out[:, 47:50].reshape(B, 3, N, N, N))


def test_fused_volume_staggered_stops_match_jax_kernel():
    """The design's 8 robots, each with its own stop time within the launch
    (steps 4.5 to 32.5 of 40), so each freezes on its own step with its own
    recomputed dt: the plain version against the JAX kernel in interpret
    mode at the fused test's tolerances. Without the features: under volume
    effects the JAX kernel's voxel pass rebinds the name `nd`
    (evosoro_tpu/ops/fused_rollout.py:1250) that its feature carry
    unpacks at :1124, so with any feature on it fails to trace; the next
    test holds the features' frozen-robot sample against the port's eager
    trace instead. The JAX rollout's outputs are read from
    `tests/fixtures/volume_kernel_jax.npz` (`make_volume_kernel_jax.py`)
    after checking that it ran on these inputs."""
    B, steps = 8, 40
    case = staggered_case()
    jb, dt, sim, stops, jstats, jstate = case
    js = stored(VOLUME_FIXTURE, "staggered", *case)
    body = convert.body_from_numpy(_np(jb))
    psim, penv = convert.sim_params_from_jax(sim), convert.env_params_from_jax(ENV)
    pstats = fr.make_stats(body, B, dt, psim, penv)
    pstats[:, fr._S_STOP] = torch.as_tensor(stops, dtype=torch.float32)
    np.testing.assert_array_equal(pstats.numpy(), np.asarray(jstats))
    out, ps = fr.fused_rollout(convert.state_from_numpy(_np(jstate)), body, psim, penv,
                               steps, dt, stats=pstats)
    # every robot froze within the launch, each at its own time
    t = ps.time.numpy()
    assert (t >= stops).all() and (t < stops + dt).all() and len(set(t.tolist())) == B
    np.testing.assert_allclose(t, js["time"], rtol=1e-6)
    assert len(set(out.cur_dt.numpy().tolist())) > B // 2  # each froze on its own dt
    for f in ("cm_captured", "diverged"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(), js[f], err_msg=f)
    np.testing.assert_allclose(ps.ini_cm.numpy(), js["ini_cm"], rtol=2e-4, atol=2e-8)
    np.testing.assert_allclose(out.pos.numpy(), js["pos"], rtol=2e-4, atol=2e-8)
    for name, rtol, atol in (("ts_sum", 2e-3, 1e-6), ("cs_area", 1e-4, 0.0)):
        np.testing.assert_allclose(getattr(out, name).numpy(), js[name],
                                   rtol=rtol, atol=atol, err_msg=name)


def test_volume_norm_dist_by_vol_online_accumulation():
    """NormDistByVol under volume effects, where each step's dt is its own:
    the fused path's online sum (the plain version of the volume instance's
    feature instance) against a dense recomputation at the same cadence
    from the eager rollout's per-step trace, as
    tests/test_torch_features.py holds it without volume effects; the
    robot stops within the launch, so its last sample is the dry step's."""
    jb = _design(jnp.float32)
    body = convert.body_from_numpy(_np(jb))
    dt = float(calc_max_dt(body, True)) * float(SIM.dt_frac)
    steps = 60
    sim = convert.sim_params_from_jax(SIM).replace(init_cm_time=2 * dt,
                                                   stop_condition_value=50.5 * dt)
    env = convert.env_params_from_jax(ENV).replace(norm_dist_by_vol=True,
                                                   time_between_traces=2.5 * dt)
    state = init_state(body, volume_effects=True)
    batched = state.replace(**{f.name: getattr(state, f.name)[None]
                               for f in dataclasses.fields(state)
                               if torch.is_tensor(getattr(state, f.name))})
    _, stats = fr.fused_rollout(batched, body, sim, env, num_steps=steps, dt=dt,
                                stop_time=float(sim.stop_condition_value))
    res = rollout(body, sim, env, steps + 1, dt=dt, trace_every=1,
                  state=init_state(body, volume_effects=True),
                  stop_time=float(sim.stop_condition_value))
    cms = res.cm_trace[1:steps + 1, 1].double().numpy()
    vols = res.vol_trace[1:steps + 1].double().numpy()
    times = res.trace_times[1:steps + 1].double().numpy()
    nd, last_t, prev = 0.0, -1.0, None
    for cy, vol, t in zip(cms, vols, times):
        if t > sim.init_cm_time and (prev is None or last_t + env.time_between_traces <= t):
            if prev is not None:
                avg = 0.5 * (vol + prev[1])
                nd += (cy - prev[0]) / body.nominal_size / (avg if avg > 0 else 1.0)
            prev, last_t = (cy, vol), t
    assert abs(nd) > 0 and float(stats.time[0]) < steps * dt
    np.testing.assert_allclose(float(stats.norm_dist_by_vol[0]), nd, rtol=2e-4, atol=1e-7)


def _host_vol(lib, args, kw, steps):
    lib.emu_fwd_vol.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                                + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int,
                                                        ctypes.c_void_p, ctypes.c_void_p,
                                                        ctypes.c_int, ctypes.c_int,
                                                        ctypes.c_void_p, ctypes.c_int,
                                                        ctypes.c_void_p, ctypes.c_void_p])
    state, body, stats, table = args
    B, X, Y, Z = state.shape[0], *kw["grid_shape"]
    flags, scalars = kw["flags"], kw["scalars"]
    bc = kw.get("bc_packed")

    def batched(t):
        return int(t is not None and t.shape[0] == B and B > 1)

    st, sa = state.clone(), stats.clone()
    lib.emu_fwd_vol(st.data_ptr(), body.data_ptr(), batched(body), sa.data_ptr(),
                    table.data_ptr() if table is not None else None, batched(table), 0, B, X,
                    Y, Z, steps, fr._k1_params(scalars, fr.DEFAULT_PRECISION).ctypes.data,
                    fr._flag_bits(flags), fr._feat_params(scalars, flags).ctypes.data, None,
                    0, 0, bc.data_ptr() if bc is not None else None, batched(bc),
                    fr._mat_params(scalars).ctypes.data, fr._vol_params(scalars).ctypes.data)
    return st, sa


def _bc_contact_workload():
    """The volume experiment's evaluator batch (3 designs padded to 8, a
    body, pair table and dt per robot, contact on) with one constrained axis
    per robot: the x translation of the x = 0 layer held, and a force in +z
    on the far layer."""
    args, kw = bench.volume_workload(pop_size=3, device="cpu")
    B, _, V = args[0].shape
    X, Y, Z = kw["grid_shape"]
    x = torch.arange(V) // (Y * Z)
    occ = args[1][:, fr._B_OCC] > 0.5
    bc = torch.zeros((B, 15, V))
    bc[:, 0] = torch.where(occ & (x == 0), 1.0, 0.0)  # DOF_X
    bc[:, 8] = torch.where(occ & (x == X - 1), 0.05, 0.0)  # external force, z
    return args, dict(kw, flags=dict(kw["flags"], bc=True), bc_packed=bc.contiguous())


@pytest.mark.parametrize("case", ["design", "bc_contact", "features"])
def test_host_compiled_volume_instance_matches_plain(host_lib, case):  # noqa: F811
    """`emu_fwd_vol` (the volume instance of the `.cu`, one thread a block)
    against `fused_rollout_plain` over 40 steps: every channel group the
    rollout carries and the coupling carry within 1e-4 of the group's
    largest plain value, the rotational groups within 2e-3, as
    tests/test_torch_k1_host.py holds the material instance (g++'s libm is
    not torch's: its pow of the transverse contraction differs in the last
    bits; and the emulation sums the pair pass in another order), the stats
    row's dt and time at rtol 1e-6. The guard: the volume bit cleared lands
    far outside."""
    steps = 40
    if case == "design":
        args, kw = bench.volume_scenario_workload(3, device="cpu")
    elif case == "bc_contact":
        args, kw = _bc_contact_workload()
    else:
        args, kw = bench.volume_workload(pop_size=3, collision=False, device="cpu",
                                         features=True)
    out_h, st_h = _host_vol(host_lib, args, kw, steps)
    out_p, st_p = fr.fused_call(*args, num_steps=steps, **kw)
    groups = dict(pos=(0, 3), quat=(3, 7), linmom=(7, 10), angmom=(10, 13), scale=(13, 14),
                  last_pos2=(17, 26), max_strain=(44, 47), ts=(47, 50), cs=(50, 53))

    def worst(got):
        w = 0.0
        for name, (a, b) in groups.items():
            top = float(out_p[:, a:b].abs().max())
            rel = float((got[:, a:b] - out_p[:, a:b]).abs().max()) / top
            w = max(w, rel / 20 if name in ("quat", "angmom") else rel)
        return w

    assert worst(out_h) <= 1e-4
    for k in (fr._S_DT, fr._S_TIME):
        torch.testing.assert_close(st_h[:, k], st_p[:, k], rtol=1e-6, atol=0.0)
    assert float(out_p[:, 47:50].abs().max()) > 1e-5
    if case == "bc_contact":
        x_held = args[0][:, fr._POS][kw["bc_packed"][:, 0] > 0.5]
        assert torch.equal(out_h[:, fr._POS][kw["bc_packed"][:, 0] > 0.5], x_held)
    if case == "features":
        assert torch.equal(st_h[:, fr._S_NTR], st_p[:, fr._S_NTR])
    off = dict(kw, flags=dict(kw["flags"], volume=False))
    assert worst(_host_vol(host_lib, args, off, steps)[0]) > 100 * 1e-4


def test_entry_points_carry_and_refuse_as_jax():
    jb = _design(jnp.float32)
    body = convert.body_from_numpy(_np(jb))
    psim, penv = convert.sim_params_from_jax(SIM), convert.env_params_from_jax(ENV)
    s = init_state(body, volume_effects=True)
    assert s.ts_sum.shape == s.cs_area.shape == (2, 3, N, N, N) and s.cur_dt.shape == ()
    assert float(s.ts_sum.abs().max()) == 0.0 and float(s.cur_dt) == 0.0
    assert torch.equal(s.cs_area, torch.full_like(s.cs_area, float(np.float32(0.01 * 0.01))))
    bare = init_state(body)
    with pytest.raises(ValueError, match="coupling carry"):
        sim_step(bare, body, psim, penv, 1e-5)
    batched = bare.replace(**{f.name: getattr(bare, f.name)[None]
                              for f in dataclasses.fields(bare)
                              if torch.is_tensor(getattr(bare, f.name))})
    with pytest.raises(ValueError, match="coupling carry"):
        fr.fused_rollout(batched, body, psim, penv, 1, 1e-5)
    assert fr.supports(body, psim, penv) and jfr.supports(jb, SIM, ENV)
    # in water and with development volume effects run too; ballistic
    # development in water stays outside, by name
    flags = fr.launch_flags(body, psim, penv)
    for other in (dict(fluid=True), dict(use_final_size=True)):
        fr.check_envelope(dict(flags, **other), {})
    with pytest.raises(NotImplementedError, match="ballistic"):
        fr.check_envelope(dict(flags, fluid=True, use_final_size=True, ballistic=True), {})
    # the reverse-mode kernel refuses them, as the JAX package's does
    assert not fr.diff_envelope_ok(flags, {}) and not jfr._diff_envelope_ok(
        tuple(flags.items()), ())
    with pytest.raises(ValueError, match="differentiable"):
        FusedSQPSolver(body, psim, penv, num_steps=16, num_knots=4, n_res=4, device="cpu")
    with pytest.raises(ValueError, match="differentiable"):
        JFusedSQPSolver(jb, SIM, ENV, num_steps=16, num_knots=4, n_res=4)
    # a JAX state with the carry comes across, each field as it is
    st = j_sim_step(j_init_state(jb, volume_effects=True), jb, SIM, ENV,
                    float(j_calc_max_dt(jb, True)) * 0.9)
    conv = convert.state_from_numpy(_np(st))
    for name in ("ts_sum", "cs_area", "cur_dt"):
        np.testing.assert_array_equal(getattr(conv, name).numpy(), np.asarray(getattr(st, name)))


def test_control_entry_points_build_the_carry():
    """The batch runner, the fused and eager CEM solves and the eager
    gradient path start from `init_state(volume_effects=True)` and the
    volume rest dt, as the JAX package's do (shooting.py:87,159,539,
    sqp.py:129, FusedBatchRunner)."""
    jb = _design(jnp.float32)
    body = convert.body_from_numpy(_np(jb))
    psim, penv = convert.sim_params_from_jax(SIM), convert.env_params_from_jax(ENV)
    runner = fr.FusedBatchRunner(body, psim, penv, batch=4, num_steps=10, num_knots=2)
    jrunner = jfr.FusedBatchRunner(jb, SIM, ENV, batch=8, num_steps=10, num_knots=2)
    V = N ** 3
    np.testing.assert_array_equal(runner.state_packed[0].numpy(),
                                  np.asarray(jrunner.state_packed)[0, :, :V])
    np.testing.assert_allclose(runner.stats[:, fr._S_DT].numpy(),
                               np.asarray(jrunner.stats)[:4, jfr._S_DT], rtol=1e-7)
    assert runner.call_kwargs["flags"]["volume"]
    u = torch.as_tensor(np.random.default_rng(0).uniform(-0.02, 0.02, size=(4, 2, N, N, N)),
                        dtype=torch.float32)
    m = runner.run(u)
    assert bool(torch.isfinite(m["norm_final_dist"]).all()) and not bool(m["diverged"].any())
    gen = torch.Generator().manual_seed(0)
    cfg = CEMConfig(num_iters=2, pop_size=4)
    for solve in (cem_optimize_fused, cem_optimize):
        _, info = solve(gen, body, psim, penv, num_steps=10, num_knots=2, config=cfg,
                        device="cpu")
        assert math.isfinite(float(info["best_cost"])) and float(info["best_cost"]) < 1e9


def test_evaluator_volume_step_counts_and_redispatch(monkeypatch):
    """A `Sim` whose `to_sim_params` turns volume effects on, in both
    packages: the step counts before the ladder (the 15 % pad on the volume
    rest dt) and after it equal JAX's; a first launch that ends short of the
    stop time is made once more, 1.5 times as long."""
    for mod, cls in ((base, Sim), (j_base, j_base.Sim)):
        real = cls.to_sim_params
        monkeypatch.setattr(cls, "to_sim_params", lambda self, real=real: real(
            self).replace(volume_effects_enabled=True))
    seen = {"jax": [], "port": []}
    for key, mod in (("jax", j_evaluation), ("port", evaluation)):
        real_ladder = mod._ladder_steps
        monkeypatch.setattr(mod, "_ladder_steps", lambda n, key=key, real=real_ladder:
                            seen[key].append((n, real(n))) or real(n))

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    for name in ("make_fused_evaluator", "make_batched_evaluator"):
        monkeypatch.setattr(j_evaluation, name, stop)
    sim_kw = dict(dt_frac=0.9, simulation_time=0.05, fitness_eval_init_time=0.01)
    pop_j = _population(JGenotype, JPhenotype, JPopulation, JCPPN, j_base.ObjectiveDict,
                        j_material_tree, tissues=("1", "2"))
    with pytest.raises(Stop):
        j_evaluation.evaluate_all(j_base.Sim(**sim_kw), j_base.Env(), pop_j)
    pop_p = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                        make_material_tree, tissues=("1", "2"))
    inds = [ind for ind in pop_p if ind.phenotype.is_valid()]
    for ind in inds:
        ind.md5 = ind.genotype.phenotype_md5()
    evaluation._batch_fields(Sim(**sim_kw), Env(), inds)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == len(inds) > 0
    assert all(n > 100 for n, _ in seen["port"])  # 0.05 s is over a hundred steps

    # the re-dispatch: every launch of 16 steps (a robot of soft tissue and
    # muscle takes steps of ~4e-4 s, so 16 cover 0.002 s), the first one
    # made to end short
    monkeypatch.setattr(evaluation, "_ladder_steps", lambda n: 16)
    calls = []
    real_make = evaluation.make_fused_evaluator

    def make(*a, **k):
        fn = real_make(*a, **k)

        def short_first(*args, num_steps=None):
            out = fn(*args, num_steps=num_steps)
            calls.append(num_steps)
            if len(calls) == 1:
                out = dict(out, final_time=0.5 * out["final_time"])
            return out

        short_first.pack, short_first.launch_kw = fn.pack, fn.launch_kw
        return short_first

    monkeypatch.setattr(evaluation, "make_fused_evaluator", make)
    pop_p = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                        make_material_tree, tissues=("1", "1"))
    evaluation.evaluate_all(Sim(dt_frac=0.9, simulation_time=0.002,
                                fitness_eval_init_time=0.0005), Env(), pop_p, device="cpu")
    assert calls == [16, 24]
    assert evaluation.LAST_DISPATCH_TIMING["redispatches"] == 1
    assert evaluation.LAST_DISPATCH_TIMING["short_after_redispatch"] == 0
    assert evaluation.LAST_DISPATCH_TIMING["short_ids"] == []
    assert evaluation.LAST_DISPATCH_TIMING["num_steps"] == 24
    assert all(np.isfinite(ind.fitness) for ind in pop_p)


def test_relaunch_until_stop_runs_at_most_twice_more():
    """The relaunch rule the evaluator and the replay share: 1.5 times the
    steps while a rollout ends short, at most twice, and the rollouts still
    short after the last launch come back as a mask."""
    calls = []

    def run(n):
        calls.append(n)
        return n

    _, n, k, short = relaunch_until_stop(run, 100, lambda r: np.array([r < 1000, r < 150]))
    assert calls == [100, 150, 225] and n == 225 and k == 2
    assert short.tolist() == [True, False]
    calls.clear()
    _, n, k, short = relaunch_until_stop(run, 100, lambda r: np.array([r < 150]))
    assert calls == [100, 150] and n == 150 and k == 1 and not short.any()


def test_volume_vxa_round_trip_and_replay(tmp_path):
    """An archived design written back with `write_vxa` and
    VolumeEffectsEnabled set reads the same in both packages, and
    `bench.replay` runs it whole (its stop time cut to 0.004 s) with the
    volume carry; the cantilever with volume effects reads the same too."""
    src = bench.fixture_paths()[0]
    path = bench.write_volume_vxa(src, str(tmp_path / "volume.vxa"), stop_time=0.004)
    cant = bench.write_cantilever_vxa(str(tmp_path / "cantilever.vxa"), n=4, max_vel=False,
                                      volume=True)
    for p in (path, cant):
        doc, jdoc = load_vxa(p), j_load_vxa(p)
        assert doc.sim.volume_effects_enabled and jdoc.sim.volume_effects_enabled
        np.testing.assert_array_equal(doc.structure, np.asarray(jdoc.structure))
        for name in ("dt_frac", "stop_condition_value", "self_collisions_enabled"):
            assert getattr(doc.sim, name) == getattr(jdoc.sim, name), name
        for name in ("temp_enabled", "temp_amplitude", "temp_period", "gravity_enabled"):
            assert float(getattr(doc.env, name)) == float(getattr(jdoc.env, name)), name
    np.testing.assert_array_equal(load_vxa(path).structure, load_vxa(src).structure)
    rec = bench.replay(path, device="cpu")
    body, sim, _, dt, steps, _ = bench.replay_setup(path, device="cpu")
    assert rec["volume"] and not rec["diverged"] and math.isfinite(rec["fitness"])
    assert rec["steps"] == steps == num_steps_for(body, sim, dt)
    assert rec["final_t"] >= 0.999 * 0.004
    assert rec["final_state"].cur_dt is not None and float(rec["final_state"].cur_dt[0]) > 0
