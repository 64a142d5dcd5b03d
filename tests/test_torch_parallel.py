"""The port's multi-device paths on the CPU: batch sharding over a mesh of
repeated CPU entries (`parallel/mesh.py`), the spatial slabs
(`parallel/spatial.py`) against the JAX package on two of the conftest's
virtual devices, `dt_reduce` where the JAX package applies it, the
generation split by `evaluate_all(devices=)`, and the solvers' `mesh=`.

On CPU tensors each shard runs K1's plain version, whose results for a robot
do not depend on the other robots of its launch: the sharded runs are held
bit for bit to one call. The spatial rollout starts both packages from one
state turned away from the identity (its voxels rotated by 0.05-0.15 rad),
where the quaternion snap (`w >= 1`) cannot fire on the last bit, and is
held at JAX's own tolerances (tests/test_spatial_sharding.py:46-62: state
rtol 1e-12, the quaternions' to their unit norm, CoM fitness rtol 1e-8);
its interiors equal the port's unsharded eager rollout.
"""

import numpy as np
import pytest
import torch

from evosoro_tpu_torch import bench, convert
from evosoro_tpu_torch.control.shooting import CEMConfig, cem_optimize_fused
from evosoro_tpu_torch.control.sqp import SQPConfig, sqp_optimize_multistart
from evosoro_tpu_torch.core import (
    EnvParams,
    SimParams,
    build_body,
    calc_max_dt,
    evosoro_default_palette,
    init_state,
    palette_from_list,
    rollout,
)
from evosoro_tpu_torch.core.collision import attach_collision_system
from evosoro_tpu_torch.evo import evaluation
from evosoro_tpu_torch.evo.logging import PrintLog
from evosoro_tpu_torch.ops import fused_rollout as fr
from evosoro_tpu_torch.parallel import mesh as pm
from evosoro_tpu_torch.parallel.spatial import spatial_rollout, supports_spatial

torch.set_num_threads(1)


def _body(n=3, seed=0, dtype=torch.float32, shape=None):
    rng = np.random.default_rng(seed)
    shape = shape or (n, n, n)
    structure = rng.integers(1, 5, size=shape).astype(np.int32)
    return build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=rng.uniform(-1, 1, size=shape), dtype=dtype)


def _batch(state, B):
    return pm.tree_map(lambda t: t.expand((B,) + t.shape).clone(), state)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_fused_rollout_is_bit_equal_to_one_call(n):
    body = attach_collision_system(_body(), 2.0)
    sim = SimParams(init_cm_time=0.0, self_collisions_enabled=True)
    env = EnvParams()
    dt = float(calc_max_dt(body)) * sim.dt_frac
    state = _batch(init_state(body), 8)
    state = state.replace(pos=state.pos + 1e-4 * torch.randn(
        state.pos.shape, generator=torch.Generator().manual_seed(1)))
    one_state, one_stats = fr.fused_rollout(state, body, sim, env, num_steps=6, dt=dt)
    sh_state, sh_stats = pm.sharded_fused_rollout(state, body, sim, env, 6, dt, ["cpu"] * n)
    for a, b in ((one_state, sh_state), (one_stats, sh_stats)):
        pm.tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), a, b)
    run = pm.sharded_rollout_fn(lambda s: fr.fused_rollout(s, body, sim, env, 6, dt)[1],
                                pm.make_mesh(["cpu"] * n))
    pm.tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0),
                run(state), one_stats)
    with pytest.raises(ValueError, match="divide"):
        pm.sharded_fused_rollout(_batch(init_state(body), 6), body, sim, env, 2, dt,
                                 ["cpu"] * 4)


def test_mesh_helpers_and_refusals():
    mesh = pm.make_mesh(["cpu", "cpu", "cpu"])
    assert len(mesh) == 3 and all(d == torch.device("cpu") for d in mesh)
    tree = dict(a=torch.arange(6.0), b=(torch.ones(6, 2),))
    shards = pm.shard_batch(tree, mesh)
    assert [s["a"].tolist() for s in shards] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]
    assert torch.equal(pm.gather(shards, "cpu")["a"], tree["a"])
    reps = pm.replicate(tree, mesh)
    assert reps[0] is reps[1]  # one copy a device
    with pytest.raises(TypeError, match="not object"):
        pm.as_mesh(object())
    with pytest.raises(ValueError, match="is not a cuda device"):
        pm.check_mesh(pm.as_mesh(["cuda:0", "cpu"]), "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            pm.make_mesh()
    rates = pm.scaling_report(lambda b: b * 2, lambda d: torch.ones(4 * d), reps=1,
                              device_counts=[1, 2], devices=["cpu", "cpu"])
    assert set(rates) == {1, 2, "efficiency"} and rates[1] > 0


def test_run_shards_launches_every_shard_before_reading_one():
    """The one split-launch-gather rule (`run_shards`) that the sharded
    rollouts, the evaluator and the solvers share: every launch issued
    before any result is fetched, the results in shard order; and the row
    spans it is given."""
    assert pm.row_spans(6, 3) == [(0, 2), (2, 4), (4, 6)]
    assert pm.row_spans(7, 3, exact=False) == [(0, 2), (2, 4), (4, 7)]
    with pytest.raises(ValueError, match="divide"):
        pm.row_spans(7, 3)
    events = []
    out = pm.run_shards(lambda lo, hi, d: events.append(("launch", lo, str(d))) or hi - lo,
                        [(0, 3), (3, 4)], pm.Mesh(("cpu", "cpu")),
                        fetch=lambda x: events.append(("fetch", x)) or 10 * x)
    assert out == [30, 10]
    assert events == [("launch", 0, "cpu"), ("launch", 3, "cpu"), ("fetch", 3), ("fetch", 1)]
    # with owners, in one process: every shard is this rank's
    assert pm.run_shards(lambda lo, hi, d: lo, [(0, 1), (1, 2)], ["cpu"] * 2,
                         owners=[0, 0]) == [0, 1]


@pytest.mark.parametrize("entry", ["sharded_fused_rollout", "sharded_rollout_fn",
                                   "spatial_rollout", "cem", "sqp"])
def test_entry_points_refuse_a_mesh_entry_off_their_device(entry, monkeypatch):
    """A path asked to run on the CPU (its tensors or `device` there) with a
    card in its mesh raises by name before any shard runs: no shard moves
    to another type of device than the path's, so none of a card path's
    would fall back to the host."""
    launched = []
    monkeypatch.setattr(fr, "fused_call", lambda *a, **k: launched.append(1))
    body = _body(shape=(4, 3, 3))
    sim, env = SimParams(init_cm_time=0.0), EnvParams()
    mesh = ["cpu", "cuda:0"]
    state = _batch(init_state(body), 4)
    calls = dict(
        sharded_fused_rollout=lambda: pm.sharded_fused_rollout(state, body, sim, env, 2,
                                                               1e-4, mesh),
        sharded_rollout_fn=lambda: pm.sharded_rollout_fn(
            lambda s: fr.fused_rollout(s, body, sim, env, 2, 1e-4), mesh)(state),
        spatial_rollout=lambda: spatial_rollout(body, sim, env, 2, 1e-4, mesh),
        cem=lambda: cem_optimize_fused(torch.Generator().manual_seed(0), body, sim, env, 4,
                                       2, CEMConfig(num_iters=1, pop_size=16),
                                       device="cpu", mesh=mesh),
        sqp=lambda: sqp_optimize_multistart(torch.Generator().manual_seed(0), body, sim, env,
                                            4, 2, n_starts=2, device="cpu", mesh=mesh))
    with pytest.raises(ValueError, match="mesh entry cuda:0 is not a cpu device"):
        calls[entry]()
    assert launched == []


def _generation(experiment, **kw):
    sim, env, pop = bench.EXPERIMENTS[experiment](pop_size=8, sim_time=0.004,
                                                  init_time=0.0005, **kw)
    return sim, env, pop


@pytest.fixture
def short_buckets(monkeypatch):
    """Every step bucket cut to 24 steps (the ladder's floor is 256)."""
    monkeypatch.setattr(evaluation, "_ladder_steps", lambda n: 24)


@pytest.mark.parametrize("n", [2, 4])
def test_evaluate_all_over_devices_equals_one_device(n, short_buckets):
    """K1's route split in n shards (batch_pad 2: n_shards = min(n, 8 // 2))
    scores every individual as one launch does."""
    fits = {}
    for key, kw in (("one", dict(device="cpu")), ("mesh", dict(devices=["cpu"] * n))):
        sim, env, pop = _generation("basic", size=(4, 4, 4))
        evaluation.evaluate_all(sim, env, pop, print_log=PrintLog(), batch_pad=2, **kw)
        assert evaluation.LAST_DISPATCH_TIMING["used_fused"]
        fits[key] = (np.array([ind.fitness for ind in pop]),
                     evaluation.LAST_DISPATCH_TIMING["n_shards"])
    assert fits["one"][1] == 1 and fits["mesh"][1] == n
    assert np.array_equal(fits["one"][0], fits["mesh"][0])
    assert np.any(fits["one"][0] != 0)
    sim, env, pop = _generation("basic", size=(4, 4, 4))
    with pytest.raises(ValueError, match="not both"):
        evaluation.evaluate_all(sim, env, pop, device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="is not a cpu device"):
        evaluation.evaluate_all(sim, env, pop, devices=["cpu", "cuda:0"])


def test_eager_route_over_devices_equals_one_device(short_buckets):
    """The eager evaluator's bucket takes the same split, without pad rows."""
    fits = {}
    for key, kw in (("one", dict(device="cpu")), ("mesh", dict(devices=["cpu"] * 2))):
        sim, env, pop = _generation("limited_floor")
        evaluation.evaluate_all(sim, env, pop, print_log=PrintLog(), batch_pad=2, **kw)
        assert evaluation.LAST_DISPATCH_TIMING["used_fused"] is False
        fits[key] = np.array([ind.fitness for ind in pop])
    assert evaluation.LAST_DISPATCH_TIMING["n_shards"] == 2
    assert np.array_equal(fits["one"], fits["mesh"])


def _spatial_case():
    """tests/test_spatial_sharding.py's `_make` (16 x 5 x 4, seed 0) in
    float64, JAX's, with a start state whose voxels are turned away from the
    identity."""
    import jax.numpy as jnp

    from evosoro_tpu.core.materials import build_body as j_build_body
    from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
    from evosoro_tpu.core.materials import palette_from_list as j_palette
    from evosoro_tpu.core.rollout import init_state as j_init_state
    from evosoro_tpu.core.types import EnvParams as JEnv
    from evosoro_tpu.core.types import SimParams as JSim
    from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette

    X, Y, Z = 16, 5, 4
    rng = np.random.default_rng(0)
    structure = rng.integers(0, 5, size=(X, Y, Z)).astype(np.int32)
    structure[:, Y // 2, 0] = 3
    phase = rng.uniform(-1, 1, size=(X, Y, Z))
    jb = j_build_body(structure, j_palette(j_default_palette()), phase_offset=phase,
                      dtype=jnp.float64)
    sim, env = JSim(init_cm_time=0.001), JEnv()
    dt = float(j_calc_max_dt(jb)) * sim.dt_frac
    r = np.random.default_rng(5)
    axis = r.normal(size=(X, Y, Z, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = r.uniform(0.05, 0.15, size=(X, Y, Z, 1))
    quat = np.concatenate([np.cos(angle / 2), np.sin(angle / 2) * axis], -1)
    return jb, sim, env, dt, j_init_state(jb).replace(quat=jnp.asarray(quat))


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def test_spatial_rollout_matches_jax():
    import jax
    from jax.sharding import Mesh

    from evosoro_tpu.parallel.spatial import spatial_rollout as j_spatial_rollout

    jb, jsim, jenv, dt, jstate = _spatial_case()
    steps = 12
    ref = j_spatial_rollout(jb, jsim, jenv, steps, dt,
                            Mesh(np.array(jax.devices()[:2]), axis_names=("space",)),
                            state=jstate)
    body = convert.body_from_numpy(_np(jb), dtype=torch.float64)
    sim, env = convert.sim_params_from_jax(jsim), convert.env_params_from_jax(jenv)
    state = convert.state_from_numpy(_np(jstate), dtype=torch.float64)
    assert supports_spatial(body, sim, env)
    res = spatial_rollout(body, sim, env, steps, dt, ["cpu"] * 2, state=state)
    theirs = convert.spatial_result_from_numpy(_np(ref), dtype=torch.float64)
    # JAX's tolerances: positions at rtol 1e-12 (measured 5e-15), orientations
    # at 1e-12 of the unit quaternion's norm (measured 5.6e-15: a component
    # near zero has no relative precision to hold)
    np.testing.assert_allclose(res.final_state.pos.numpy(), theirs.final_state.pos.numpy(),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(res.final_state.quat.numpy(), theirs.final_state.quat.numpy(),
                               rtol=1e-12, atol=1e-12)
    assert torch.equal(res.final_state.scale, theirs.final_state.scale)
    np.testing.assert_allclose(float(res.final_dist), float(theirs.final_dist),
                               rtol=1e-8, atol=1e-16)
    np.testing.assert_allclose(res.ini_cm.numpy(), theirs.ini_cm.numpy(), rtol=1e-8)
    np.testing.assert_allclose(res.final_cm.numpy(), theirs.final_cm.numpy(), rtol=1e-8)
    assert bool(res.diverged) == bool(theirs.diverged) is False
    # the slabs' interiors are the port's unsharded eager rollout's, and so
    # are four slabs'
    one = rollout(body, sim, env, num_steps=steps, dt=dt, state=state)
    four = spatial_rollout(body, sim, env, steps, dt, ["cpu"] * 4, state=state)
    for r in (res, four):
        torch.testing.assert_close(r.final_state.pos, one.final_state.pos, rtol=1e-12,
                                   atol=1e-15)
        np.testing.assert_allclose(float(r.final_dist), float(one.final_dist), rtol=1e-8)


def test_spatial_volume_effects_carry_rides_the_halo():
    """Volume effects: a two-plane halo and a dt agreed over the slabs, held
    to the port's unsharded eager rollout (tests/test_spatial_sharding.py's
    8 x 4 x 3 case, seed 2)."""
    rng = np.random.default_rng(2)
    structure = rng.integers(0, 5, size=(8, 4, 3)).astype(np.int32)
    structure[:, 2, 0] = 3
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=rng.uniform(-1, 1, size=(8, 4, 3)), dtype=torch.float64)
    sim, env = SimParams(volume_effects_enabled=True), EnvParams()
    dt = float(calc_max_dt(body)) * sim.dt_frac
    res = spatial_rollout(body, sim, env, 8, dt, ["cpu"] * 4)
    ref = rollout(body, sim, env, num_steps=8, dt=dt,
                  state=init_state(body, volume_effects=True))
    for k in ("pos", "ts_sum", "cs_area"):
        torch.testing.assert_close(getattr(res.final_state, k), getattr(ref.final_state, k),
                                   rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(res.final_state.cur_dt, ref.final_state.cur_dt, rtol=1e-12,
                               atol=0)
    torch.testing.assert_close(res.final_state.time, ref.final_state.time, rtol=1e-12, atol=0)


def test_spatial_refusals():
    body = _body(shape=(6, 3, 3), dtype=torch.float64)
    sim, env = SimParams(), EnvParams()
    dt = 1e-5
    for b, s, e in ((attach_collision_system(body, 2.0), sim, env),
                    (body, sim.replace(equilibrium_mode=True), env),
                    (body, sim, env.replace(needle_in_haystack=True)),
                    (body, sim, env.replace(falling_prohibited=True)),
                    (body, sim, env.replace(floor_limited=True, floor_radius=0.02))):
        assert not supports_spatial(b, s, e)
        with pytest.raises(ValueError, match="envelope"):
            spatial_rollout(b, s, e, 1, dt, ["cpu"] * 2)
    with pytest.raises(ValueError, match="not divisible"):
        spatial_rollout(body, sim, env, 1, dt, ["cpu"] * 4)
    with pytest.raises(ValueError, match="halo"):
        spatial_rollout(body, sim.replace(volume_effects_enabled=True), env, 1, dt,
                        ["cpu"] * 6)
    with pytest.raises(TypeError, match="not object"):
        spatial_rollout(body, sim, env, 1, dt, object())


def test_dt_reduce_applies_where_jax_applies_it():
    """`dt_reduce` maps the largest bond frequency of a volume-effects step,
    as JAX's `sim_step` does (evosoro_tpu/core/step.py:844-847): the same
    reduction in both packages gives the same dt and state in float64."""
    import jax

    from evosoro_tpu.core.materials import build_body as j_build_body
    from evosoro_tpu.core.materials import palette_from_list as j_palette
    from evosoro_tpu.core.rollout import init_state as j_init_state
    from evosoro_tpu.core.step import sim_step as j_sim_step
    from evosoro_tpu.core.types import EnvParams as JEnv
    from evosoro_tpu.core.types import SimParams as JSim
    from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
    from evosoro_tpu_torch.core import sim_step

    rng = np.random.default_rng(6)
    structure = rng.integers(1, 5, size=(3, 3, 3)).astype(np.int32)
    jb = j_build_body(structure, j_palette(j_default_palette()), dtype=np.float64,
                      phase_offset=rng.uniform(-1, 1, size=(3, 3, 3)))
    jsim = JSim(volume_effects_enabled=True)
    js = j_init_state(jb, volume_effects=True)
    js = js.replace(pos=js.pos * 1.01)  # strained: the frequency moves
    theirs = _np(jax.jit(lambda s: j_sim_step(s, jb, jsim, JEnv(), 1e-5,
                                              dt_reduce=lambda f: 1.5 * f))(js))
    body = convert.body_from_numpy(_np(jb), dtype=torch.float64)
    sim, env = convert.sim_params_from_jax(jsim), convert.env_params_from_jax(JEnv())
    state = convert.state_from_numpy(_np(js), dtype=torch.float64)
    ours = sim_step(state, body, sim, env, 1e-5, dt_reduce=lambda f: 1.5 * f)
    plain = sim_step(state, body, sim, env, 1e-5)
    np.testing.assert_allclose(float(ours.cur_dt), float(theirs.cur_dt), rtol=1e-12)
    np.testing.assert_allclose(float(ours.cur_dt), float(plain.cur_dt) / 1.5, rtol=1e-12)
    np.testing.assert_allclose(ours.pos.numpy(), theirs.pos, rtol=1e-12, atol=1e-15)


def test_cem_over_a_mesh_returns_the_unsharded_solve(monkeypatch):
    body = _body()
    sim, env = SimParams(init_cm_time=0.0), EnvParams()
    cfg = CEMConfig(num_iters=2, pop_size=32)  # a multiple of 8 x 4 entries

    def solve(mesh):
        return cem_optimize_fused(torch.Generator().manual_seed(0), body, sim, env, 12, 2,
                                  cfg, device="cpu", mesh=mesh)

    u1, i1 = solve(None)
    for mesh in (["cpu", "cpu"], pm.Mesh(("cpu",) * 4)):
        u2, i2 = solve(mesh)
        assert torch.equal(u1, u2) and i1["best_cost"] == i2["best_cost"]
        assert torch.equal(i1["mean_cost_trace"], i2["mean_cost_trace"])
    # the population is rounded up to 8 x the mesh's size
    calls = []
    real = fr.fused_call
    monkeypatch.setattr(fr, "fused_call", lambda *a, **k: calls.append(a[0].shape[0])
                        or real(*a, **k))
    cem_optimize_fused(torch.Generator().manual_seed(0), body, sim, env, 4, 2,
                       CEMConfig(num_iters=1, pop_size=20), device="cpu", mesh=["cpu"] * 2)
    assert calls == [16, 16]  # 32 candidates, one launch a shard


def test_sqp_multistart_over_a_mesh_returns_the_unsharded_solve():
    body = _body(dtype=torch.float64)
    sim = SimParams(init_cm_time=0.0005)
    cfg = SQPConfig(num_iters=1, cg_iters=1, n_res=2, w_reg=1e-2)
    dt = float(calc_max_dt(body)) * sim.dt_frac

    def solve(mesh):
        return sqp_optimize_multistart(torch.Generator().manual_seed(0), body, sim,
                                       EnvParams(), 8, 2, n_starts=2, target=0.05, config=cfg,
                                       dt=dt, device="cpu", mesh=mesh)

    u1, i1 = solve(None)
    u2, i2 = solve(["cpu", "cpu"])
    assert torch.equal(u1, u2) and torch.equal(i1["all_costs"], i2["all_costs"])
    assert int(i1["best_start"]) == int(i2["best_start"])
    with pytest.raises(ValueError, match="divide"):
        solve(["cpu"] * 3)


def test_graft_entry_runs_on_the_cpu(short_buckets):
    from evosoro_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device="cpu")
    assert bool(torch.isfinite(fn(*args).pos).all())
    out = graft_entry.dryrun_multichip(2, devices=["cpu", "cpu"])
    assert out["n_shards"] == 2 and np.all(np.isfinite(out["fitness"]))
