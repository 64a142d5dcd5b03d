"""The port's eager evaluator (`evo.evaluation.make_batched_evaluator`) and
the route to it, held against the JAX package's eager evaluator on the CPU.

One module-scope pair of runs carries the parity tests: a population of 4
robots of 4^3 with contact on, under the circular limited floor, with 4
environmental sources, speed windows of 13 trace steps and a frequency per
individual (an `env_kws` override), scored on <NormFinalDist> and the 8 tags
only the eager path fills, through JAX's `evaluate_all` with
EVOSORO_TPU_FUSED_EVAL=0 and the port's with `device="cpu"`. JAX's evo
`Env.to_env_params` does not carry sources (the port's does), and nothing
scored reads them: on the port's side the 4 sources send the bucket to the
eager step beside the limited floor, the windows and the tags.

Tolerances. The two float32 trajectories part at ulps (XLA contracts FMA,
eager torch does not), which the quaternion snap at w >= 1 turns into jumps
of about 3e-4 after the actuation onset: every tag at rtol 5e-3 with an
atol of 5e-3 of its column's largest value, as
tests/test_torch_evaluation.py::test_feature_tags_match_jax holds its tags.

The population. Over 0.1 s on the limited floor most seeds hold a robot
whose float32 trajectory is ill-conditioned: it parts from its own float64
trajectory by tens of percent, in either package, while the two packages'
float64 rollouts agree to 1e-8 (`test_batched_rollout_matches_jax_vmap`
holds the batched eager rollout in float64). Of seeds 0-29, 6 have every
robot's float32 tags within the tolerances above of their float64 values;
seed 23 is one of them, with a walker, two robots that end off the floor
and mat-6 voxels on it.
"""

import math
import os
import random

import numpy as np
import pytest
import torch

from evosoro_tpu.core.collision import build_collision_system as j_build_cs
from evosoro_tpu.core.collision import collision_forces as j_collision_forces
from evosoro_tpu.core.collision import pad_collision_system as j_pad_cs
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.evo import data_analysis as j_data_analysis
from evosoro_tpu.evo import evaluation as j_evaluation
from evosoro_tpu.evo.base import Env as JEnvC
from evosoro_tpu.evo.base import ObjectiveDict as JObjectives
from evosoro_tpu.evo.base import Sim as JSimC
from evosoro_tpu.evo.networks import CPPN as JCPPN
from evosoro_tpu.evo.softbot import Genotype as JGenotype
from evosoro_tpu.evo.softbot import Phenotype as JPhenotype
from evosoro_tpu.evo.softbot import Population as JPopulation
from evosoro_tpu.utils.phenotype_mappers import make_material_tree as j_material_tree
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.core.collision import (
    build_collision_system,
    collision_forces,
    pad_collision_system,
    stack_collision_systems,
)
from evosoro_tpu_torch.envs.sources import make_sources
from evosoro_tpu_torch.evo import data_analysis, evaluation
from evosoro_tpu_torch.evo.base import Env, ObjectiveDict, Sim
from evosoro_tpu_torch.evo.networks import CPPN
from evosoro_tpu_torch.evo.softbot import Genotype, Phenotype, Population
from evosoro_tpu_torch.ops import fused_rollout as fr
from evosoro_tpu_torch.utils.phenotype_mappers import make_material_tree

torch.set_num_threads(1)
IND_SIZE = (4, 4, 4)
EAGER_ONLY_TAGS = ("<FinalDist>", "<AnteriorDist>", "<PosteriorDist>", "<AnteriorY>",
                   "<PosteriorY>", "<NumTouchingFloor>", "<NumNonFeetTouchingFloor>",
                   "<Lifetime>")
# the limited floor's radius on the 4^3 grid: the voxel centres lie 0.71,
# 1.58 or 2.12 lattice units from the floor's centre (0.02, 0.02), so the 4
# corner columns start off the floor and no centre lies within 0.27 units
# of its edge, where an ulp would flip contact
RADIUS = 0.0185
SOURCES = [dict(pos=(0.2, 0.03, 0.03), amp=(0.0, 0.05, 0.0), freq=(0.0, 0.5, 0.0),
                enabled=True),
           dict(pos=(-0.1, 0.0, 0.02), enabled=True),
           dict(pos=(0.0, 0.3, 0.0), amp=(0.02, 0.0, 0.0), freq=(1.0, 0.0, 0.0),
                enabled=True),
           dict(pos=(0.05, 0.05, 0.1), enabled=False)]
# 0.1 s of sim time: some 220 steps of a 4^3 design of soft materials, one
# 256-step launch, in which the robots walk centimetres' fractions; the
# float32 trajectories of robots that move a few micrometres part by tens of
# percent between any two orders of rounding (both packages agree to 5e-7 in
# float64 there)
SIM_KW = dict(dt_frac=0.9, simulation_time=0.1, fitness_eval_init_time=0.01)


def _frequency(x):
    """A frequency per individual from its CPPN's output: examples/
    land_continuous.py's frequency_func at 40 Hz, so that the 0.1 s held a
    few strokes."""
    return 40.0 * 2.5 / (np.mean(1 / x) + 1.5)


def _population(Genotype_, Phenotype_, Population_, CPPN_, Objectives_, material_tree,
                tags=("<NormFinalDist>",) + EAGER_ONLY_TAGS, pop_size=4, seed=23):
    """The examples/basic.py material tree at 4^3, with mat-6 feet among the
    muscles and soft mat-7 tissue in place of the stiff mat 2 (whose dt
    would put its designs in a 10 times longer bucket), and a second CPPN
    whose output sets the individual's frequency through `env_kws`;
    objectives `tags` (the first is the fitness)."""

    class _Genotype(Genotype_):
        def __init__(self):
            super().__init__(orig_size_xyz=IND_SIZE)
            names = ["shape", "muscleOrTissue", "muscleType", "tissueType"]
            self.add_network(CPPN_(output_node_names=names))
            m = self.to_phenotype_mapping
            m.add_map(name="material", tag="<Data>", func=material_tree,
                      dependency_order=names, output_type=int)
            m.add_output_dependency(name="shape", dependency_name=None,
                                    requirement=None, material_if_true=None,
                                    material_if_false="0")
            m.add_output_dependency(name="muscleOrTissue", dependency_name="shape",
                                    requirement=True, material_if_true=None,
                                    material_if_false=None)
            m.add_output_dependency(name="tissueType", dependency_name="muscleOrTissue",
                                    requirement=False, material_if_true="1",
                                    material_if_false="7")
            m.add_output_dependency(name="muscleType", dependency_name="muscleOrTissue",
                                    requirement=True, material_if_true="3",
                                    material_if_false="6")
            self.add_network(CPPN_(output_node_names=["frequency"]))
            m.add_map(name="frequency", tag="<TempPeriod>", env_kws={"frequency": _frequency})

    class _Phenotype(Phenotype_):
        def is_valid(self):
            state = self.genotype.to_phenotype_mapping["material"]["state"]
            return np.sum(state > 0) >= 8 and np.sum(state == 3) >= 2

    random.seed(seed)
    np.random.seed(seed)
    objectives = Objectives_()
    objectives.add_objective(name="fitness", maximize=True, tag=tags[0])
    objectives.add_objective(name="age", maximize=False, tag=None)
    for k, tag in enumerate(tags[1:]):
        objectives.add_objective(name=f"tag{k}", maximize=True, tag=tag)
    return Population_(objectives, _Genotype, _Phenotype, pop_size=pop_size)


def _env(cls, limited=True, n_win=13, sources=True):
    env = cls(temp_amp=64.0)
    if limited:
        env.add_param("floor_limited", 1, "<FloorLimited>")
        env.add_param("floor_radius", RADIUS, "<FloorRadius>")
    if n_win:
        env.add_param("num_trace_steps_in_window", n_win, "<NumTraceStepsInWindow>")
    if sources and cls is Env:
        env.sources = make_sources(SOURCES)
    return env


class _Log:
    """A PrintLog that keeps its lines."""

    def __init__(self):
        self.lines = []

    def message(self, text):
        self.lines.append(text)


@pytest.fixture(scope="module")
def runs():
    """JAX's eager evaluator and the port's on the same population: (JAX
    population, port population, the port's LAST_DISPATCH_TIMING, the
    port's log lines)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EVOSORO_TPU_FUSED_EVAL", "0")
        pop_j = _population(JGenotype, JPhenotype, JPopulation, JCPPN, JObjectives,
                            j_material_tree)
        j_evaluation.evaluate_all(JSimC(**SIM_KW), _env(JEnvC), pop_j)
    pop_p = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                        make_material_tree)
    log = _Log()
    evaluation.evaluate_all(Sim(**SIM_KW), _env(Env), pop_p, print_log=log, device="cpu")
    return pop_j, pop_p, dict(evaluation.LAST_DISPATCH_TIMING), log.lines


def test_the_runs_take_the_eager_path(runs):
    """The port's generation went to the eager step, for each of its
    reasons, and printed the warning line; the two populations are the
    same designs, each with its own frequency."""
    pop_j, pop_p, timing, lines = runs
    assert [i.md5 for i in pop_p] == [i.md5 for i in pop_j]
    assert timing["used_fused"] is False and timing["num_steps"] == 256
    reason = timing["eager_reason"]
    for what in ("limited floor", "objective tag <FinalDist>", "objective tag <Lifetime>"):
        assert what in reason, what
    assert any(line.startswith("WARNING: generation leaving the fused K1 path")
               for line in lines)
    freqs = {_frequency(i.genotype.to_phenotype_mapping["frequency"]["state"])
             for i in pop_p}
    assert len(freqs) == len(pop_p)


@pytest.mark.parametrize("k,tag", list(enumerate(("<NormFinalDist>",) + EAGER_ONLY_TAGS)))
def test_tags_match_jax_eager_evaluator(runs, k, tag):
    """Each tag against JAX's eager evaluator on the shared runs."""
    pop_j, pop_p, _, _ = runs
    name = "fitness" if k == 0 else f"tag{k - 1}"
    got = np.array([getattr(i, name) for i in pop_p], dtype=np.float64)
    want = np.array([getattr(i, name) for i in pop_j], dtype=np.float64)
    assert np.isfinite(got).all()
    top = np.abs(want).max()
    assert top > 0, tag
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3 * top, err_msg=tag)


def test_limited_floor_moves_the_fitness(runs):
    """The guard: the same population on the whole floor scores otherwise
    (the corner columns stand on it), through the port's eager path."""
    _, pop_p, _, _ = runs
    pop = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                      make_material_tree, tags=("<NormFinalDist>", "<NumTouchingFloor>"))
    env = _env(Env, limited=False)
    evaluation.evaluate_all(Sim(**SIM_KW), env, pop, device="cpu")
    assert evaluation.LAST_DISPATCH_TIMING["used_fused"] is False
    limited = np.array([i.tag4 for i in pop_p])  # <NumTouchingFloor>
    whole = np.array([i.tag0 for i in pop])
    assert (whole > limited).any()


def test_batched_rollout_matches_jax_vmap():
    """The eager evaluator's rollout in float64: the population's four
    designs stacked into one body with their padded contact tables, each
    with its own dt and frequency, under the limited floor, through the
    port's `rollout` against JAX's `rollout` vmapped over the designs and
    their environments (128 steps, actuation from step 22; the stacked
    environment carried across by `convert.env_params_from_jax`); every tag
    the evaluator reads at 1e-6 of its column's largest value."""
    import jax
    import jax.numpy as jnp

    from evosoro_tpu.core.collision import attach_collision_system as j_attach
    from evosoro_tpu.core.materials import build_body as j_build_body
    from evosoro_tpu.core.materials import calc_max_dt as j_calc_max_dt
    from evosoro_tpu.core.materials import palette_from_list as j_palette
    from evosoro_tpu.core.rollout import rollout as j_rollout
    from evosoro_tpu.core.types import SimParams as JSim
    from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
    from evosoro_tpu_torch.core.materials import calc_max_dt, stack_bodies
    from evosoro_tpu_torch.core.rollout import rollout

    pop = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                      make_material_tree)
    structures = [i.genotype.to_phenotype_mapping["material"]["state"].astype(np.int32)
                  for i in pop]
    periods = [1.0 / float(_frequency(i.genotype.to_phenotype_mapping["frequency"]["state"]))
               for i in pop]
    S = max(int((build_collision_system(st, np.ones(st.shape), 0.01).surf_mask).sum())
            for st in structures)
    jbodies = [j_attach(j_build_body(st, j_palette(j_default_palette()), dtype=jnp.float64),
                        pad_to=S) for st in structures]
    jenvs = [JEnv(temp_amplitude=39.0, temp_period=p, floor_limited=True,
                  floor_radius=RADIUS) for p in periods]
    jsim = JSim(init_cm_time=0.01, self_collisions_enabled=True)

    def stack(*x):
        return jnp.stack(x)

    jb, je = (jax.tree_util.tree_map(stack, *t) for t in (jbodies, jenvs))

    def one(b, e):
        r = j_rollout(b, jsim, e, num_steps=128, dt=j_calc_max_dt(b) * jsim.dt_frac,
                      stop_time=0.1)
        return [getattr(r, n) for n in _EAGER_KEYS]

    want = [np.asarray(a) for a in jax.jit(jax.vmap(one))(jb, je)]
    body = stack_bodies([convert.body_from_numpy(jax.tree_util.tree_map(np.asarray, b),
                                                 dtype=torch.float64) for b in jbodies])
    body = body.replace(collision=stack_collision_systems(
        [convert.collision_from_numpy(b.collision) for b in jbodies], dtype=torch.float64))
    # the stacked environment, converted: one value a robot in every scalar
    env = convert.env_params_from_jax(je)
    assert env.floor_limited is True and tuple(env.temp_period.shape) == (4,)
    np.testing.assert_array_equal(env.temp_period.numpy(), periods)
    res = rollout(body, convert.sim_params_from_jax(jsim), env, num_steps=128,
                  dt=calc_max_dt(body) * jsim.dt_frac, stop_time=0.1)
    for name, w in zip(_EAGER_KEYS, want):
        got = getattr(res, name).numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=name)
    assert np.abs(want[0]).max() > 1e-3  # the robots moved


# the RolloutResult fields behind <NormFinalDist> and the 8 eager-only tags
_EAGER_KEYS = ("norm_final_dist", "final_dist", "anterior_dist", "posterior_dist",
               "anterior_y", "posterior_y", "num_touching_floor",
               "num_non_feet_touching_floor", "lifetime")


def test_pad_and_stacked_collision_forces_match_jax_vmap():
    """`pad_collision_system` and `collision_forces` over a stack of two
    different designs' tables against JAX's `collision_forces` vmapped over
    its padded systems; the pad entries repeat index 0 and must add
    nothing."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    designs = [rng.integers(0, 4, size=(4, 4, 4)).astype(np.int32) for _ in range(2)]
    designs[1][:, :, 2:] = 0  # fewer surface voxels: the pad entries matter
    e = [np.where(d > 0, 1e6, 0.0) for d in designs]
    j_sys = [j_build_cs(d, ei, 0.01) for d, ei in zip(designs, e)]
    p_sys = [build_collision_system(d, ei, 0.01) for d, ei in zip(designs, e)]
    S = max(cs.surf_idx.shape[0] for cs in p_sys)
    assert p_sys[1].surf_idx.shape[0] < S
    for jc, pc in zip(j_sys, p_sys):
        jp, pp = j_pad_cs(jc, S), pad_collision_system(pc, S)
        for f in ("surf_idx", "surf_mask", "pair_a1", "allowed"):
            np.testing.assert_array_equal(getattr(pp, f), np.asarray(getattr(jp, f)))
    # squeeze each design about its centre so distant surface voxels touch
    nom = (np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1) + 0.5) * 0.01
    pos = np.stack([0.02 + 0.6 * (nom - 0.02) + rng.normal(0, 3e-4, nom.shape)
                    for _ in range(2)]).astype(np.float32)
    scale = np.full((2, 4, 4, 4), 0.01, np.float32)
    stacked_j = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                       *[j_pad_cs(c, S) for c in j_sys])
    f_j = np.asarray(jax.vmap(j_collision_forces)(jnp.asarray(pos), jnp.asarray(scale),
                                                   stacked_j))
    stacked = stack_collision_systems(p_sys)
    assert tuple(stacked.pair_a1.shape) == (2, S, S)
    f_p = collision_forces(torch.as_tensor(pos), torch.as_tensor(scale), stacked).numpy()
    assert np.abs(f_j[1]).max() > 0
    np.testing.assert_allclose(f_p, f_j, rtol=1e-5, atol=1e-5 * np.abs(f_j).max())
    for i in range(2):  # each row equals its design alone
        alone = collision_forces(torch.as_tensor(pos[i]), torch.as_tensor(scale[i]), p_sys[i])
        torch.testing.assert_close(torch.as_tensor(f_p[i]), alone, rtol=0, atol=0)
    # attach_collision_system builds a body's own tables
    from evosoro_tpu_torch.core.collision import attach_collision_system
    from evosoro_tpu_torch.core.materials import build_body, palette_from_list
    from evosoro_tpu_torch.core.types import evosoro_default_palette

    pal = palette_from_list(evosoro_default_palette())
    body = attach_collision_system(build_body(designs[1], pal, device="cpu"))
    own = build_collision_system(designs[1], pal.elastic_mod.numpy()[designs[1]], 0.01)
    for f in ("surf_idx", "surf_mask", "pair_a1", "allowed"):
        np.testing.assert_array_equal(getattr(body.collision, f), getattr(own, f))


def test_env_params_from_jax_carry_the_limited_floor_and_rows():
    """`convert.env_params_from_jax` carries the limited floor, and the
    eager evaluator's batched environment holds a scalar that differs per
    individual as a float32 row, one that does not as its float32 value."""
    env = convert.env_params_from_jax(JEnv(floor_limited=True, floor_radius=RADIUS))
    assert env.floor_limited is True and env.floor_radius == RADIUS
    a, b = Env(frequency=4.0).to_env_params(), Env(frequency=5.0).to_env_params()
    batched = evaluation._batch_env([a, b], "cpu")
    assert torch.equal(batched.temp_period,
                       torch.tensor([0.25, 0.2], dtype=torch.float32))
    assert batched.grav_acc == float(np.float32(-9.81))
    with pytest.raises(NotImplementedError, match="floor_slope"):
        evaluation._batch_env([a, a.replace(floor_slope=0.1)], "cpu")


def _small(tag="<NormFinalDist>", **env_kw):
    pop = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                      make_material_tree, tags=(tag,))
    return Sim(**SIM_KW), _env(Env, **env_kw), pop


def test_generation_inside_the_envelope_takes_k1(monkeypatch):
    """No feature outside K1's envelope and no eager-only tag: K1's launch
    (its plain version on the CPU) runs the generation."""
    monkeypatch.setattr(evaluation, "_ladder_steps", lambda n: 8)
    calls = []
    real = fr.fused_call
    monkeypatch.setattr(fr, "fused_call", lambda *a, **k: calls.append(1) or real(*a, **k))
    sim, env, pop = _small(limited=False, n_win=0, sources=False)
    evaluation.evaluate_all(sim, env, pop, device="cpu")
    assert evaluation.LAST_DISPATCH_TIMING["used_fused"] is True
    assert evaluation.LAST_DISPATCH_TIMING["eager_reason"] is None and calls


def test_a_failing_k1_launch_raises_instead_of_going_eager(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("K1 launch failed")

    monkeypatch.setattr(fr, "fused_call", broken)
    sim, env, pop = _small(limited=False, n_win=0, sources=False)
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        evaluation.evaluate_all(sim, env, pop, device="cpu")


@pytest.mark.parametrize("case,reason", [
    ("limited", "limited floor"),
    ("sources", "more than 3 environmental sources"),
    ("window", "1-12 trace steps in a window"),
    ("tag", "objective tag <PosteriorY> is filled only by the eager evaluator"),
])
def test_each_route_names_its_reason(monkeypatch, case, reason):
    """Each case outside K1's envelope names its reason in
    `eager_reason`, and the eager step scores the generation."""
    monkeypatch.setattr(evaluation, "_ladder_steps", lambda n: 8)
    monkeypatch.setattr(fr, "fused_call", None)  # K1 must not be reached
    sim, env, pop = _small(tag="<PosteriorY>" if case == "tag" else "<NormFinalDist>",
                           limited=case == "limited", n_win=13 if case == "window" else 0,
                           sources=case == "sources")
    evaluation.evaluate_all(sim, env, pop, device="cpu")
    timing = evaluation.LAST_DISPATCH_TIMING
    assert timing["used_fused"] is False and reason in timing["eager_reason"]
    assert all(np.isfinite(i.fitness) for i in pop)


def test_eager_generation_relaunches_under_volume_effects(monkeypatch):
    """Volume effects on the eager path: the dt each step recomputes leaves
    the rollouts short of the stop time in the step count the ladder gives,
    and the bucket is launched again 1.5 times as long, as on K1's path
    (`core.rollout.relaunch_until_stop`)."""
    from evosoro_tpu_torch import bench

    monkeypatch.setattr(evaluation, "_ladder_steps", lambda n: 8)
    _, env, pop = bench.limited_floor_experiment(pop_size=4, sim_time=0.004,
                                                 init_time=0.001)
    sim = bench.VolumeSim(dt_frac=0.9, simulation_time=0.004, fitness_eval_init_time=0.001)
    evaluation.evaluate_all(sim, env, pop, device="cpu")
    timing = evaluation.LAST_DISPATCH_TIMING
    assert timing["used_fused"] is False and timing["redispatches"] >= 1
    assert timing["short_after_redispatch"] == 0 and timing["num_steps"] > 8
    assert all(np.isfinite(i.fitness) for i in pop)


def test_without_a_card_device_none_still_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    monkeypatch.setattr(evaluation, "make_batched_evaluator", None)
    sim, env, pop = _small()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        evaluation.evaluate_all(sim, env, pop)


def test_data_analysis_reads_the_port_logs_as_jax_does(tmp_path):
    """Both packages' `get_all_data` read the Gen_*.txt files that the
    port's `evo.logging` writes into equal frames (two generations)."""
    from evosoro_tpu_torch.evo import logging as plog

    pop = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                      make_material_tree, tags=("<NormFinalDist>",))
    run = str(tmp_path)
    plog.initialize_folders(pop, run, "run")
    for gen in range(2):
        for k, ind in enumerate(pop):
            ind.fitness = 0.1 * k + gen
        pop.gen = gen
        plog.make_gen_directories(pop, run, 0, False)
        plog.write_gen_stats(pop, run, "run", 0, False, False, save_lineages=False)
    got = data_analysis.get_all_data(str(tmp_path))
    want = j_data_analysis.get_all_data(str(tmp_path))
    assert len(got) == 2 * len(pop)
    assert list(got.columns) == list(want.columns)
    assert got.equals(want)
    best = data_analysis.best_per_generation(got)
    assert best["fitness"].tolist() == j_data_analysis.best_per_generation(want)[
        "fitness"].tolist()
    assert math.isclose(best["fitness"].iloc[-1], 0.1 * (len(pop) - 1) + 1)
    assert os.path.isdir(os.path.join(tmp_path, "allIndividualsData"))


def test_selection_agreement_runs_both_paths(monkeypatch):
    """`evosoro_tpu_torch.selection_agreement` on the CPU at a cut size:
    one population through K1's plain version and through the eager
    evaluator, both arms scored, and the record's statistics in range."""
    from evosoro_tpu_torch import selection_agreement

    monkeypatch.setattr(evaluation, "_ladder_steps", lambda n: 8)
    rec = selection_agreement.agreement(pop=6, size=4, sim_time=0.004, init_time=0.001,
                                        device="cpu")
    assert rec["valid"] == len(rec["fitness_kernel"]) == len(rec["fitness_eager"]) > 0
    assert -1.0 <= rec["spearman"] <= 1.0 and -1.0 <= rec["kendall"] <= 1.0
    assert set(rec["wall_s"]) == {"kernel", "eager"}
    assert selection_agreement.spearman(np.arange(5.0), np.arange(5.0)) == 1.0
    assert selection_agreement.kendall(np.arange(5.0), -np.arange(5.0)) == -1.0
