"""Bodies past one block's shared memory: 12^3 and 13^3 robots on the CPU.

K1 and B4 keep a robot's buffer (bond forces; with contact the staged
positions, scales and contact forces) in one block's shared memory while it
fits, and past that in device memory (`ops.fused_rollout.k1_instance`).
The two instances are one step on two kinds of pointer; on the card
`chip_smoke.py --big` holds them bit for bit against each other. Here:

- the instance choice at the shared ceilings and `supports()` at 12^3 and
  13^3, with and without contact, and in water in the corner shell;
- `fused_rollout` at 12^3 with contact (its plain version on CPU tensors)
  and the port's eager `rollout`, both in float64, against the JAX
  package's jitted eager rollout in float64 with its collision system
  attached, at tests/test_torch_rollout.py's tolerances, where a dropped
  pair table fails;
- the step built for the host by g++ (tests/cuda_host/, one thread a
  block: the code the device-memory instances run, on a host buffer) at
  12^3, with the dense pair pass, in a 13^3 shell with the facet drag, and
  B4's adjoint at 12^3, against the plain versions at the group tolerances
  of tests/test_torch_k1_host.py (1e-4) and tests/test_torch_b4_host.py
  (2e-4); a state read one cell off (a per-channel offset wrong by one), a
  zeroed pair table and a zero drag coefficient each fail them;
- the evaluator's per-launch pair-table cap: a 12^3 generation of three
  robots in three slices scores as in one launch.

Robots start with their lattice shrunk about its centre, so surface voxels
far apart on the lattice touch from the first step, and the contact pass
carries real forces over these few steps.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_b4_host import GROUPS as B4_GROUPS  # noqa: F401
from test_torch_b4_host import host_backward, host_forward, host_lib  # noqa: F401
from test_torch_k1_host import _worst

from evosoro_tpu.core.collision import attach_collision_system
from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.core.rollout import rollout as j_rollout
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu_torch import bench, convert
from evosoro_tpu_torch.core import EnvParams, SimParams, build_body, rollout
from evosoro_tpu_torch.core import evosoro_default_palette, palette_from_list
from evosoro_tpu_torch.envs.drag import attach_mesh_drag
from evosoro_tpu_torch.evo import evaluation
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)

STEPS = 8
# tests/test_torch_rollout.py: metres, and the final state's other channels
TOL = dict(pos=(1e-7, 1e-9), quat=(1e-7, 1e-7), linmom=(1e-4, 1e-10), scale=(1e-12, 0.0))
HOST_TOL = 1e-4  # tests/test_torch_k1_host.py
B4_TOL = 2e-4  # tests/test_torch_b4_host.py
SHRINK = (0.8, 0.85)  # robot 0's and robot 1's lattice about its centre


def _shrunk(pos, factor):
    """Positions (..., X, Y, Z, 3) pulled towards their occupied centre."""
    centre = pos.reshape(-1, 3).mean(0)
    return centre + factor * (pos - centre)


# ---------------------------------------------------------------------------
# instance choice and the envelope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("V,coll,n_surf,want", [
    (1339, True, None, "shared"), (1340, True, None, "device"),
    (1612, False, None, "shared"), (1613, False, None, "device"),
    (1400, True, 700, "shared"), (1400, True, 1400, "device"), (1400, True, None, "device"),
    (12 ** 3, False, None, "device"), (13 ** 3, True, None, "device"),
])
def test_instance_choice_at_the_shared_ceilings(V, coll, n_surf, want):
    """`k1_instance` is `k1_fits`'s complement: 36 floats a cell without
    contact; with it 39, and the pair pass's float4 an entry (a cell, or a
    surface cell with the compact pass) padded to whole 32-entry groups and
    its tables, 9 floats and a mask word for each 32 groups a group, the
    whole rounded up to 4 floats; beside 208 bytes of static shared memory
    in 232448. B4 asks without contact."""
    assert fr.k1_instance(V, coll, n_surf) == want
    assert (want == "shared") == fr.k1_fits(V, coll, n_surf)
    G = ((n_surf or V) + 31) // 32
    with_pass = 39 * V + 128 * G + 9 * G + G * ((G + 31) // 32)
    assert fr.k1_buffer_floats(V, coll, n_surf) == (
        (with_pass + 3) // 4 * 4 if coll else 36 * V)


@pytest.mark.parametrize("coll", [False, True])
@pytest.mark.parametrize("shape", [(5, 5, 4), (6, 6, 6), (7, 7, 7), (8, 8, 8), (10, 10, 10),
                                   (12, 12, 12)])
def test_block_size_and_resident_state(host_lib, shape, coll):  # noqa: F811
    """K1's block, as csrc/k1_step.cuh's `k1_threads` gives it to the
    launcher (built here by g++): a thread a bond item (3 V rounded up to a
    warp) up to the kernel's __launch_bounds__ (`k1_bound`, which the
    kernels are built with), never fewer than the reductions' partition
    (the old block, min(V rounded up, 256)) nor more than 1024. The state
    stays resident in shared memory where it fits beside the buffer and the
    static part in 232448 bytes (227 KB): through 8^3 with and without
    contact (V <= 540 with it, 580 without), not at 10^3 or 12^3."""
    import math

    V = math.prod(shape)
    for mat in (False, True):
        for feat in (False, True):
            T = host_lib.emu_k1_threads(V, mat, coll, feat)
            bound = host_lib.emu_k1_bound(mat, coll, feat)
            assert T % 32 == 0
            assert min(256, (V + 31) // 32 * 32) <= T <= bound <= 1024
            assert T == min(bound, (3 * V + 31) // 32 * 32)
            # 384 only where the dense pass meets the features or materials
            assert bound == (384 if coll and (mat or feat) else 512)
    need = (fr.k1_buffer_floats(V, coll) + fr.C_S * V) * 4 + fr._K1_STATIC_SMEM
    assert fr.k1_resident(V, coll) == (need <= 232448) == (V <= 512)
    assert fr.k1_resident(540 if coll else 580, coll)
    assert not fr.k1_resident(541 if coll else 581, coll)
    if fr.k1_resident(V, coll):
        assert fr.k1_instance(V, coll) == "shared"


@pytest.mark.parametrize("n", [12, 13])
def test_supports_big_bodies(n):
    """`supports()` is true at 12^3 and 13^3 with and without contact, and
    for a 12^3 swimmer in its 13^3 shell with the facet drag; the runner and
    the differentiable rollout are built there on the CPU."""
    from evosoro_tpu_torch.ops.fused_diff import DiffRollout

    structure, phase, _ = bench.big_body_design(n)
    pal = palette_from_list(evosoro_default_palette())
    body = build_body(structure, pal, phase_offset=phase)
    for coll in (False, True):
        assert fr.supports(body, SimParams(self_collisions_enabled=coll), EnvParams())
    shell = ((0, 1),) * 3
    swimmer = attach_mesh_drag(build_body(np.pad(structure, shell), pal,
                                          phase_offset=np.pad(phase, shell)))
    water = EnvParams(fluid_environment=True, gravity_enabled=False, floor_enabled=False)
    for coll in (False, True):
        assert fr.supports(swimmer, SimParams(self_collisions_enabled=coll), water)
    runner = fr.FusedBatchRunner(body, SimParams(), EnvParams(), batch=2, num_steps=4,
                                 num_knots=2)
    assert runner.state_packed.shape == (2, fr.C_S, n ** 3)
    diff = DiffRollout(body, SimParams(init_cm_time=0.0),
                       EnvParams(gravity_enabled=False, floor_enabled=False),
                       num_steps=4, num_knots=2, dt=1e-5, batch=2, n_segs=2)
    assert diff.grid_shape == (n, n, n)


# ---------------------------------------------------------------------------
# fused_rollout at 12^3 with contact against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_12():
    """The big-body design at 12^3 with its collision system, two robots
    shrunk into contact, and JAX's jitted eager rollout of them in float64."""
    structure, phase, _ = bench.big_body_design(12)
    jb = j_build_body(structure, j_palette(j_default_palette()), phase_offset=phase,
                      dtype=jnp.float64)
    jb = attach_collision_system(jb)
    sim_kw = dict(self_collisions_enabled=True, init_cm_time=0.0)
    dt = float(j_calc_max_dt(jb)) * 0.9
    s0 = j_init_state(jb, dtype=jnp.float64)
    pos = np.stack([_shrunk(np.asarray(s0.pos), f) for f in SHRINK])
    states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), s0)
    states = states.replace(pos=jnp.asarray(pos))

    def one(st):
        return j_rollout(jb, JSim(**sim_kw), JEnv(), num_steps=STEPS, dt=dt, state=st)

    ref = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(one))(states))
    return jb, sim_kw, dt, states, ref


def _port_inputs(jb, states, dtype):
    body = convert.body_from_numpy(jax.tree_util.tree_map(np.asarray, jb), dtype=dtype)
    state = convert.state_from_numpy(jax.tree_util.tree_map(np.asarray, states), dtype=dtype)
    return body, state


def _fails(got, ref):
    """Channel groups of a final state outside TOL, and whether the
    small-angle flags differ."""
    bad = []
    for name, (rtol, atol) in TOL.items():
        a = getattr(got, name).double().numpy()
        b = getattr(ref, name)
        if not np.all(np.abs(a - b) <= atol + rtol * np.abs(b)):
            bad.append(name)
    if not np.array_equal(got.small_angle.numpy(), ref.small_angle):
        bad.append("small_angle")
    return bad


def test_eager_rollout_at_12_cubed_with_contact_matches_jax(jax_12):
    """The port's eager rollout (the plain version's step) in float64."""
    jb, sim_kw, dt, states, ref = jax_12
    body, state = _port_inputs(jb, states, torch.float64)
    out = rollout(body, SimParams(**sim_kw), EnvParams(), num_steps=STEPS, dt=dt,
                  state=state)
    assert _fails(out.final_state, ref.final_state) == []


def test_fused_rollout_at_12_cubed_with_contact_matches_jax(jax_12):
    """`fused_rollout` takes the 12^3 contact batch (1728 cells, past the
    shared ceiling of 1339: K1's device-memory instance on the card) and on
    CPU tensors in float64 lands within the tolerances of JAX's rollout;
    without the pair table the same rollout lands outside them."""
    jb, sim_kw, dt, states, ref = jax_12
    body, state = _port_inputs(jb, states, torch.float64)
    sim = SimParams(**sim_kw)
    assert fr.k1_instance(12 ** 3, True) == "device" and fr.supports(body, sim, EnvParams())
    new, outs = fr.fused_rollout(state, body, sim, EnvParams(), STEPS, dt)
    assert new.pos.dtype == torch.float64 and _fails(new, ref.final_state) == []
    np.testing.assert_allclose(outs.time.numpy(), ref.final_state.time, rtol=1e-12)
    # the contact forces moved the voxels by far more than the tolerance
    dropped, _ = fr.fused_rollout(state, body.replace(collision=None), sim, EnvParams(),
                                  STEPS, dt)
    assert "pos" in _fails(dropped, ref.final_state)


# ---------------------------------------------------------------------------
# the host-built step at 12^3 and in a 13^3 shell
# ---------------------------------------------------------------------------


def _shrunk_args(args, kw, factors):
    """The packed launch with each robot's positions shrunk into contact."""
    state = args[0].clone()
    X, Y, Z = kw["grid_shape"]
    occ = args[1][:, fr._B_OCC] > 0.5
    for b, f in enumerate(factors):
        p = state[b, fr._POS:fr._POS + 3]
        m = occ[b if occ.shape[0] > 1 else 0]
        centre = p[:, m].mean(1, keepdim=True)
        state[b, fr._POS:fr._POS + 3] = torch.where(m, centre + f * (p - centre), p)
    return (state,) + tuple(args[1:])


def _host_mat(lib, args, kw, steps, table):
    """K1's material instance built for the host (the land step with the
    dense pair pass on `table`) over `steps` steps."""
    state, body, stats, _ = args
    B, _, V = state.shape
    X, Y, Z = kw["grid_shape"]
    st, sa = state.clone(), stats.clone()
    params = fr._k1_params(kw["scalars"], fr.DEFAULT_PRECISION)
    fparams = fr._feat_params(kw["scalars"], kw["flags"])
    mparams, vparams = fr._mat_params(kw["scalars"]), np.zeros(3, np.float32)
    lib.emu_fwd_vol(st.data_ptr(), body.data_ptr(), int(body.shape[0] == B), sa.data_ptr(),
                    table.data_ptr(), int(table.shape[0] == B), 0, B, X, Y, Z, steps,
                    params.ctypes.data, fr._flag_bits(kw["flags"]), fparams.ctypes.data,
                    None, 0, 0, None, 0, mparams.ctypes.data, vparams.ctypes.data)
    return st, sa


@pytest.fixture(scope="module")
def host_vol(host_lib):  # noqa: F811
    import ctypes

    P, I = ctypes.c_void_p, ctypes.c_int
    host_lib.emu_fwd_vol.argtypes = [P, P, I, P, P, I] + [I] * 6 + [P, I, P, P, I, I, P, I,
                                                                   P, P]
    return host_lib


def test_host_step_at_12_cubed_with_contact_matches_plain(host_vol):
    """The 12^3 batch shrunk into contact, 4 steps: the dense pair pass and
    the step at 1728 cells, as the device-memory instance runs them."""
    args, kw, _ = bench.big_body_workload(2, n=12, device="cpu")
    args = _shrunk_args(args, kw, SHRINK)
    table = args[3]
    out_h, st_h = _host_mat(host_vol, args, kw, 4, table)
    out_p, st_p = fr.fused_call(*args, num_steps=4, **kw)
    assert _worst(out_h, out_p) <= HOST_TOL
    torch.testing.assert_close(st_h[:, :fr._S_INICM], st_p[:, :fr._S_INICM],
                               rtol=1e-6, atol=1e-9)
    # IniCM sums 1202 voxels' positions, in order on the host, pairwise in
    # torch: K1's position tolerance
    ini = slice(fr._S_INICM, fr._S_INICM + 3)
    torch.testing.assert_close(st_h[:, ini], st_p[:, ini], rtol=2e-5, atol=1e-9)
    # a zeroed pair table, and the state read one cell off
    out_0, _ = _host_mat(host_vol, args, kw, 4, torch.zeros_like(table))
    assert _worst(out_0, out_p) > 100 * HOST_TOL
    shifted = (torch.roll(args[0], -1, dims=2).contiguous(),) + args[1:]
    out_s, _ = _host_mat(host_vol, shifted, kw, 4, table)
    assert _worst(out_s, out_p) > 100 * HOST_TOL


def _host_k1(lib, args, kw, steps):
    state, body, stats, _ = args
    ctrl = torch.zeros((state.shape[0], 1, state.shape[2]))
    return host_forward(lib, state, body, stats, ctrl, 0,
                        dict(kw, num_steps=steps, n_knots=0, total_steps=steps))


def test_host_step_in_a_13_cubed_shell_with_facet_drag_matches_plain(host_lib):  # noqa: F811
    """A 12^3 swimmer in its 13^3 corner shell (2197 cells), the facet drag
    at 200 times the swimming experiment's coefficient (where drag weighs
    as much as elasticity), 20 steps; without drag it fails."""
    args, kw, _ = bench.big_body_workload(2, n=12, collision=False, device="cpu", fluid=True)
    assert kw["grid_shape"] == (13, 13, 13) and kw["flags"]["fluid_mesh"]
    stats = args[2].clone()
    stats[:, fr._S_DRAGC] = 200 * bench.AGGREGATE_DRAG_COEF
    args = (args[0], args[1], stats, None)
    out_h, st_h = _host_k1(host_lib, args, kw, 20)
    out_p, st_p = fr.fused_call(*args, num_steps=20, **kw)
    assert float(out_p[:, fr._LIN:fr._LIN + 3].abs().max()) > 0
    assert _worst(out_h, out_p) <= HOST_TOL
    torch.testing.assert_close(st_h[:, :fr._S_STOP], st_p[:, :fr._S_STOP],
                               rtol=1e-6, atol=1e-9)
    no_drag = stats.clone()
    no_drag[:, fr._S_DRAGC] = 0.0
    out_0, _ = _host_k1(host_lib, (args[0], args[1], no_drag, None), kw, 20)
    assert _worst(out_0, out_p) > 100 * HOST_TOL


def test_host_adjoint_at_12_cubed_matches_autograd(host_lib):  # noqa: F811
    """B4's adjoint (forward recompute and reverse sweep) on the SQP
    workload's body at 12^3, two robots, 3 steps of a 24-step clock with 3
    knots, from rest, against autograd through the plain version."""
    from evosoro_tpu_torch.core.rollout import init_state

    body, sim, _, dt = bench.mpc_workload(n=12, device="cpu")
    env = EnvParams(gravity_enabled=False, floor_enabled=False)
    B, K, S = 2, 3, 3
    state = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
    V = state.shape[2]
    rng = np.random.default_rng(3)
    ctrl = torch.as_tensor(rng.uniform(-0.05, 0.05, (B, K, V)), dtype=torch.float32)
    cot = torch.as_tensor(rng.standard_normal(state.shape), dtype=torch.float32)
    cot[:, fr._TSAVG:] = 0.0
    stats = fr.make_stats(body, B, dt, sim, env)
    kw = dict(num_steps=S, grid_shape=(12, 12, 12),
              scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=dict(fr.kernel_env_flags(sim, env), **fr.body_flags(body),
                         collision=False, segmented=True), n_knots=K, total_steps=24)
    got = host_backward(host_lib, state, fr.pack_body(body), stats, ctrl, 0, cot, kw)
    ref = fr.fused_bwd_plain(state, fr.pack_body(body), stats, ctrl, 0, cot, **kw)
    worst = 0.0
    for a, b in list(B4_GROUPS.values())[:-1]:
        top = float(ref[0][:, a:b].abs().max())
        err = float((got[0][:, a:b] - ref[0][:, a:b]).abs().max())
        worst = max(worst, err / top if top > 0 else err)
    top = float(ref[1].abs().max())
    assert top > 0
    worst = max(worst, float((got[1] - ref[1]).abs().max()) / top)
    assert worst <= B4_TOL
    # the state read one cell off
    shifted = torch.roll(state, -1, dims=2).contiguous()
    bad = host_backward(host_lib, shifted, fr.pack_body(body), stats, ctrl, 0, cot, kw)
    assert float((bad[1] - ref[1]).abs().max()) / top > 100 * B4_TOL


# ---------------------------------------------------------------------------
# the evaluator's per-launch pair-table cap
# ---------------------------------------------------------------------------


def test_launch_slice_follows_the_jax_evaluators_arithmetic(monkeypatch):
    """Robots a launch takes: a generation at 13^3 with contact goes in
    slices of the {1, 1.5}·2^k ladder below the budget's count (8 GiB over
    19.3 MB a table: 444, cut to 384 in units of 8); without contact, or
    where the tables fit, whole."""
    sim, env, _ = bench.basic_experiment(pop_size=2)
    land = [env.to_env_params()]
    assert evaluation._launch_slice(sim, env, land, (13, 13, 13), 1024, 8) == 384
    assert evaluation._launch_slice(sim, env, land, (6, 6, 6), 15, 8) >= 15
    monkeypatch.setattr(evaluation, "PAIR_BYTES_PER_LAUNCH", 12 ** 6 * 4)
    assert evaluation._launch_slice(sim, env, land, (12, 12, 12), 3, 1) == 1
    assert evaluation._launch_slice(sim, env, land, (12, 12, 12), 3, 8) == 8
    sim.self_collisions_enabled = False
    assert evaluation._launch_slice(sim, env, land, (12, 12, 12), 3, 1) == 3
    # in water the facet drag's corner shell sizes the tables: 13^3 for a
    # 12^3 genome, so a budget of two 12^3 tables holds one of them
    sim.self_collisions_enabled = True
    _, wenv, _ = bench.swimming_experiment(pop_size=2)
    water = [wenv.to_env_params()]
    assert evaluation._launch_grid(wenv, water, (12, 12, 12)) == ((13, 13, 13), True)
    assert evaluation._launch_grid(env, land, (12, 12, 12)) == ((12, 12, 12), False)
    monkeypatch.setattr(evaluation, "PAIR_BYTES_PER_LAUNCH", 2 * 12 ** 6 * 4)
    assert evaluation._launch_slice(sim, env, land, (12, 12, 12), 3, 1) == 2
    assert evaluation._launch_slice(sim, wenv, water, (12, 12, 12), 3, 1) == 1


def test_sliced_generation_scores_as_one_launch(monkeypatch):
    """A 12^3 generation of three robots with contact, each launch cut to 4
    steps (the step ladder patched): with a budget of one 12^3 table the
    bucket goes in three slices of one robot, and every fitness equals the
    whole launch's."""
    monkeypatch.setattr(evaluation, "_ladder_steps", lambda n: 4)
    sim, env, pop = bench.basic_experiment(pop_size=3, size=(12, 12, 12), init_time=0.0)
    runs = {}
    default = evaluation.PAIR_BYTES_PER_LAUNCH
    for budget in (default, 12 ** 6 * 4):
        monkeypatch.setattr(evaluation, "PAIR_BYTES_PER_LAUNCH", budget)
        p = copy.deepcopy(pop)
        evaluation.evaluate_all(sim, env, p, device="cpu", batch_pad=1)
        runs[budget] = ([ind.fitness for ind in p],
                        list(evaluation.LAST_DISPATCH_TIMING["buckets"]))
    whole, sliced = runs[default], runs[12 ** 6 * 4]
    assert whole[1] == [dict(num_steps=4, batch=3)]
    assert sliced[1] == [dict(num_steps=4, batch=1)] * 3
    assert any(f > 0 for f in whole[0])
    assert sliced[0] == whole[0]
