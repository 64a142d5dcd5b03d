"""The port's evolution layer held against the JAX package on the CPU: twin
populations seeded identically get the same NormFinalDist from both
`evaluate_all`s (on land, in water with either drag model, and with
development genomes), and the archived VXA files are byte-identical."""

import math
from functools import partial

import os
import random

import numpy as np
import pytest
import torch

from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu.evo import evaluation as j_evaluation
from evosoro_tpu.evo.base import Env as JEnvC
from evosoro_tpu.evo.base import ObjectiveDict as JObjectives
from evosoro_tpu.evo.base import Sim as JSimC
from evosoro_tpu.evo.networks import CPPN as JCPPN
from evosoro_tpu.evo.softbot import Genotype as JGenotype
from evosoro_tpu.evo.softbot import Phenotype as JPhenotype
from evosoro_tpu.evo.softbot import Population as JPopulation
from evosoro_tpu.io.vxa import write_vxa as j_write_vxa
from evosoro_tpu.utils.functional import rescaled_positive_sigmoid as j_sigmoid
from evosoro_tpu.utils.phenotype_mappers import make_material_tree as j_material_tree
from evosoro_tpu_torch.core.types import EnvParams, SimParams, evosoro_default_palette
from evosoro_tpu_torch.evo import evaluation
from evosoro_tpu_torch.evo.base import Env, ObjectiveDict, Sim
from evosoro_tpu_torch.evo.networks import CPPN
from evosoro_tpu_torch.evo.softbot import Genotype, Phenotype, Population
from evosoro_tpu_torch.io.vxa import write_vxa
from evosoro_tpu_torch.utils.functional import rescaled_positive_sigmoid
from evosoro_tpu_torch.utils.phenotype_mappers import make_material_tree

torch.set_num_threads(1)
IND_SIZE = (4, 4, 4)


def _population(Genotype_, Phenotype_, Population_, CPPN_, Objectives_,
                material_tree, seed=11, tag="<NormFinalDist>", tissues=("1", "2"),
                muscles=("3", "4"), more_tags=()):
    """The examples/basic.py material-tree genome at 4³, pop 4; `tissues`
    and `muscles` are its tissue and muscle materials, `more_tags`
    objectives of their own."""

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
                                    requirement=False, material_if_true=tissues[0],
                                    material_if_false=tissues[1])
            m.add_output_dependency(name="muscleType", dependency_name="muscleOrTissue",
                                    requirement=True, material_if_true=muscles[0],
                                    material_if_false=muscles[1])

    class _Phenotype(Phenotype_):
        def is_valid(self):
            state = self.genotype.to_phenotype_mapping["material"]["state"]
            return np.sum(state > 0) >= 4 and np.sum(np.isin(state, muscles_i)) >= 2

    muscles_i = [int(m) for m in muscles]
    random.seed(seed)
    np.random.seed(seed)
    objectives = Objectives_()
    objectives.add_objective(name="fitness", maximize=True, tag=tag)
    objectives.add_objective(name="age", maximize=False, tag=None)
    for k, more in enumerate(more_tags):
        objectives.add_objective(name=f"tag{k}", maximize=True, tag=more)
    return Population_(objectives, _Genotype, _Phenotype, pop_size=4)


def test_evaluate_all_matches_jax(monkeypatch):
    """Collision on; 0.01 s of sim time keeps every design on the 256-step
    floor of the step ladder."""
    monkeypatch.setenv("EVOSORO_TPU_FUSED_EVAL", "0")
    pop_j = _population(JGenotype, JPhenotype, JPopulation, JCPPN, JObjectives,
                        j_material_tree)
    j_evaluation.evaluate_all(
        JSimC(dt_frac=0.9, simulation_time=0.01, fitness_eval_init_time=0.002),
        JEnvC(), pop_j)
    pop_p = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                        make_material_tree)
    evaluation.evaluate_all(
        Sim(dt_frac=0.9, simulation_time=0.01, fitness_eval_init_time=0.002),
        Env(), pop_p, device="cpu")
    assert evaluation.LAST_DISPATCH_TIMING["num_steps"] == 256
    assert [i.md5 for i in pop_p] == [i.md5 for i in pop_j]
    fit_j = np.array([i.fitness for i in pop_j])
    fit_p = np.array([i.fitness for i in pop_p])
    assert np.isfinite(fit_p).all() and np.abs(fit_p).max() > 0
    np.testing.assert_allclose(fit_p, fit_j, rtol=5e-3, atol=1e-5)


def _frequency(x):
    """examples/land_continuous.py's frequency_func, with a top frequency of
    400 Hz in place of 4 so that the 0.01 s these tests simulate hold a few
    strokes."""
    return 400.0 * 2.5 / (np.mean(1 / x) + 1.5)


def _experiment_population(kind, Genotype_, Phenotype_, Population_, CPPN_, Objectives_,
                           material_tree, sigmoid, seed=5):
    """Twins of the examples' genomes at 4^3, pop 4: `complex` is the
    land_continuous genotype (phase offsets, a global frequency as an env
    override, per-voxel stiffness, a two-output material tree), `growth`
    the two size networks of examples/growth.py on a 4x4x3 all-muscle body."""
    if kind == "basic":
        return _population(Genotype_, Phenotype_, Population_, CPPN_, Objectives_,
                           material_tree, seed=seed, tag="<normAbsoluteDisplacement>")

    class _Complex(Genotype_):
        def __init__(self):
            super().__init__(orig_size_xyz=IND_SIZE)
            self.add_network(CPPN_(output_node_names=["phase_offset", "frequency"]))
            m = self.to_phenotype_mapping
            m.add_map(name="phase_offset", tag="<PhaseOffset>",
                      func=partial(sigmoid, x_min=0, x_max=2 * math.pi))
            m.add_map(name="frequency", tag="<TempPeriod>",
                      env_kws={"frequency": _frequency})
            self.add_network(CPPN_(output_node_names=["shape", "muscleOrTissue",
                                                      "stiffness"]))
            m.add_map(name="stiffness", tag="<Stiffness>",
                      func=partial(sigmoid, x_min=0.01e6, x_max=1e6),
                      params=[0.01e6, 1e6], param_tags=["MinElasticMod", "MaxElasticMod"])
            m.add_map(name="material", tag="<Data>", func=material_tree,
                      dependency_order=["shape", "muscleOrTissue"], output_type=int)
            m.add_output_dependency(name="shape", dependency_name=None, requirement=None,
                                    material_if_true=None, material_if_false="0")
            m.add_output_dependency(name="muscleOrTissue", dependency_name="shape",
                                    requirement=True, material_if_true="3",
                                    material_if_false="1")

    class _Growth(Genotype_):
        def __init__(self):
            super().__init__(orig_size_xyz=(4, 4, 3))
            self.add_network(CPPN_(output_node_names=["initial_size"]))
            self.to_phenotype_mapping.add_map(name="initial_size",
                                              tag="<InitialVoxelSize>")
            self.add_network(CPPN_(output_node_names=["final_size"]))
            self.to_phenotype_mapping.add_map(name="final_size", tag="<FinalVoxelSize>")

    class _Valid(Phenotype_):
        def is_valid(self):
            state = self.genotype.to_phenotype_mapping["material"]["state"]
            return np.sum(state > 0) >= 4 and np.sum(state == 3) >= 2

    random.seed(seed)
    np.random.seed(seed)
    objectives = Objectives_()
    objectives.add_objective(name="fitness", maximize=True,
                             tag="<normAbsoluteDisplacement>" if kind == "complex"
                             else "<NormFinalDist>")
    objectives.add_objective(name="age", maximize=False, tag=None)
    if kind == "complex":
        return Population_(objectives, _Complex, _Valid, pop_size=4)
    return Population_(objectives, _Growth, Phenotype_, pop_size=4)


def _water(env):
    """Water thick enough (200 times the experiments' drag coefficient) that
    a swimmer gets somewhere within the 0.01 s these tests simulate."""
    env.add_param("fluid_environment", 1, "<FluidEnvironment>")
    env.add_param("aggregate_drag_coefficient", 1.5e5, "<AggregateDragCoefficient>")
    return env


# case -> (genome, in water, drag model, expected flags of the port's launch)
_EXPERIMENTS = {
    "swimming": ("basic", True, "mesh", dict(fluid=True, fluid_mesh=True)),
    "swimming_voxel_face": ("basic", True, "voxel_face", dict(fluid=True, fluid_mesh=False)),
    "swimming_complex": ("complex", True, "mesh", dict(fluid=True, fluid_mesh=True)),
    "growth": ("growth", False, "mesh", dict(fluid=False, use_init_size=True,
                                             use_final_size=True, use_growth_t=True)),
}


@pytest.mark.parametrize("case", list(_EXPERIMENTS))
def test_experiments_match_jax(monkeypatch, case):
    """One population of each shipped experiment's genome through both
    evaluators: the swimmers (examples/swimming_basic.py and
    swimming_complex.py) under the default facet drag and under
    `drag_model="voxel_face"`, and examples/growth.py's development genome.
    0.01 s of sim time (one 256-step launch), actuation from 0.002 s at
    400 Hz so that the swimmers get three strokes in; fitness at rtol 5e-3 as tests/test_evaluation.py:117. The port's launch
    must carry the flags of the model asked for, and the shell only with the
    facet drag."""
    genome, water, drag_model, want = _EXPERIMENTS[case]
    monkeypatch.setenv("EVOSORO_TPU_FUSED_EVAL", "0")
    sim_kw = dict(dt_frac=0.9, simulation_time=0.01, fitness_eval_init_time=0.002)
    env_kw = dict(temp_amp=64.0)
    if genome == "growth":
        sim_kw.update(dt_frac=0.5, min_temp_fact=0.4)
    else:
        env_kw.update(frequency=400.0, drag_model=drag_model)

    def env_of(cls):
        env = cls(**env_kw)
        if genome == "growth":
            env.add_param("growth_amplitude", 0.8, "<GrowthAmplitude>")
        return _water(env) if water else env

    pop_j = _experiment_population(genome, JGenotype, JPhenotype, JPopulation, JCPPN,
                                   JObjectives, j_material_tree, j_sigmoid)
    j_evaluation.evaluate_all(JSimC(**sim_kw), env_of(JEnvC), pop_j)
    pop_p = _experiment_population(genome, Genotype, Phenotype, Population, CPPN,
                                   ObjectiveDict, make_material_tree,
                                   rescaled_positive_sigmoid)
    from evosoro_tpu_torch.ops import fused_rollout as fr

    launches = []
    real = fr.fused_call

    def recording(*args, **kw):
        launches.append((kw["flags"], kw["grid_shape"]))
        return real(*args, **kw)

    monkeypatch.setattr(fr, "fused_call", recording)
    evaluation.evaluate_all(Sim(**sim_kw), env_of(Env), pop_p, device="cpu")
    assert [i.md5 for i in pop_p] == [i.md5 for i in pop_j]
    assert len(launches) == 1
    flags, grid = launches[0]
    for k, v in want.items():
        assert flags[k] == v, k
    base = (4, 4, 3) if genome == "growth" else IND_SIZE
    assert grid == (tuple(g + 1 for g in base) if want.get("fluid_mesh") else base)
    fit_j = np.array([i.fitness for i in pop_j])
    fit_p = np.array([i.fitness for i in pop_p])
    assert np.isfinite(fit_p).all() and np.abs(fit_p).max() > 1e-4  # ten times atol
    np.testing.assert_allclose(fit_p, fit_j, rtol=5e-3, atol=1e-5)


def test_evaluate_all_without_a_device_argument_needs_the_card(monkeypatch):
    """`device=None` means the card. Without one `evaluate_all` raises and
    names `device="cpu"`, instead of evaluating through the plain versions
    unasked; nobody gets a fitness."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    from evosoro_tpu_torch.ops import fused_rollout as fr

    monkeypatch.setattr(fr, "fused_rollout_plain", None)
    pop = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                      make_material_tree)
    before = [ind.fitness for ind in pop]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        evaluation.evaluate_all(Sim(simulation_time=0.01), Env(), pop)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        evaluation.evaluator_batch(Sim(simulation_time=0.01), Env(), list(pop))
    assert [ind.fitness for ind in pop] == before
    assert not hasattr(evaluation, "default_device")


def test_evaluator_batch_packs_each_design_in_its_row():
    """What the evaluator hands the fused rollout: row i holds design i's own
    body, pair table, dt and stop time; pad rows repeat row 0."""
    from evosoro_tpu_torch.core.collision import build_collision_system
    from evosoro_tpu_torch.core.materials import build_body, calc_max_dt
    from evosoro_tpu_torch.ops import fused_rollout as fr

    pop = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                      make_material_tree)
    sim = Sim(dt_frac=0.9, simulation_time=0.01)
    fn, inputs = evaluation.evaluator_batch(sim, Env(), list(pop), device="cpu")
    state, body, stats, table, ss = fn.pack(*inputs)
    structures = inputs[0]
    assert ss is None  # the default palette has no MDL_DATA tables
    assert state.shape == (8, fr.C_S, 64) and body.shape == (8, fr.C_B, 64)
    assert stats.shape == (8, fr.C_STAT) and table.shape == (8, 64, 64)
    assert fn.launch_kw["flags"]["collision"] and fn.launch_kw["num_steps"] == 256
    palette = evaluation.palette_from_list(evaluation.evosoro_default_palette())
    for i, ind in enumerate(pop):
        s = ind.genotype.to_phenotype_mapping["material"]["state"].astype(np.int32)
        np.testing.assert_array_equal(structures[i], s)
        b = build_body(s, palette)
        torch.testing.assert_close(body[i], fr.pack_body(b)[0], rtol=0, atol=0)
        cs = build_collision_system(s, palette.elastic_mod.numpy()[s], 0.01)
        np.testing.assert_array_equal(table[i].numpy(), fr.pack_collision(cs, IND_SIZE))
        assert stats[i, fr._S_DT] == torch.as_tensor(calc_max_dt(b) * 0.9,
                                                     dtype=torch.float32)
        assert stats[i, fr._S_STOP] == torch.tensor(0.01, dtype=torch.float32)
    for i in range(len(pop), 8):
        for t in (state, body, stats, table):
            assert torch.equal(t[i], t[0])


@pytest.mark.parametrize("what", ["devo", "objective"])
def test_dispatch_refuses_unported_genomes(what):
    """Ballistic development in a fluid (a final size evolved under speed
    windows, in water) and the tags that only the JAX package's eager
    evaluator fills still raise, by name."""
    pop = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                      make_material_tree,
                      tag="<PosteriorY>" if what == "objective" else "<NormFinalDist>")
    env = Env()
    if what == "devo":
        for ind in pop:
            ind.genotype.add_network(CPPN(output_node_names=["growth"]))
            ind.genotype.to_phenotype_mapping.add_map(
                name="growth", tag="<FinalVoxelSize>", output_type=float)
            ind.genotype.express()
        env.add_param("num_trace_steps_in_window", 4, "<NumTraceStepsInWindow>")
        env.time_between_traces = 0.01
        _water(env)
    with pytest.raises(NotImplementedError,
                       match="ballistic|window" if what == "devo" else "objective tag"):
        evaluation.evaluate_all(Sim(simulation_time=0.01), env, pop, device="cpu")


# the seven tags of the fitness features beside NormFinalDist (which
# NormDistByVol turns into the trace sum): 12 tags with the five of before
_FEATURE_TAGS = ("<NormRegimeDist>", "<NormFrozenDist>", "<EndOfLifePosteriorY>",
                 "<FallAdjPostY>", "<FoundNeedleInHaystack>", "<PushDist>", "<WindowDist>")
# filled only by the JAX package's eager evaluator, not ported yet
_EAGER_ONLY_TAGS = ("<FinalDist>", "<AnteriorDist>", "<PosteriorDist>", "<AnteriorY>",
                    "<PosteriorY>", "<NumTouchingFloor>", "<NumNonFeetTouchingFloor>",
                    "<Lifetime>")


def _features_env(cls):
    """NormDistByVol, the fall-over latch, the needle and windows of 4 trace
    steps, a trace every 0.0015 s (about 2.6 steps of a 4³ design): 19
    traces, 4 windows; actuation at 40 Hz (some 40 steps a period), so that
    the robots move within the launch."""
    env = cls(time_between_traces=0.0015, frequency=40.0, temp_amp=64.0)
    for name, tag in (("norm_dist_by_vol", "<NormDistByVol>"),
                      ("falling_prohibited", "<FallingProhibited>"),
                      ("needle_in_haystack", "<NeedleInHaystack>")):
        env.add_param(name, 1, tag)
    env.add_param("num_trace_steps_in_window", 4, "<NumTraceStepsInWindow>")
    return env


def test_feature_tags_match_jax(monkeypatch):
    """The port maps 12 objective tags: a population with mat-7 needles
    among its tissues and mat-6 feet among its muscles, scored on
    NormFinalDist and on the seven feature tags at once, through both
    `evaluate_all`s, the JAX package's on its fused kernel in interpret mode
    (its eager path samples the trace on another clock); contact off. Both
    step ladders are cut to one 64-step launch, since each interpreted step
    costs JAX's kernel a fraction of a second: 0.032 s (55 steps of 5.8e-4
    s), IniCM at 0.004 s, a mid-life freeze of 0.01 s. The tag map is
    JAX's for each of the 12 tags. Every tag at the rtol 5e-3 of the other
    experiment cases, with an atol of 5e-3 of its column's largest value:
    the plain version runs float32, JAX's kernel FMA-contracted, and
    NormDistByVol sums signed steps whose rounding follows their size, not
    the sum's. The walking robots' distances stand far above that atol."""
    assert len(evaluation._OBJECTIVE_TAG_TO_RESULT) == 12
    for tag, name in evaluation._OBJECTIVE_TAG_TO_RESULT.items():
        assert j_evaluation._OBJECTIVE_TAG_TO_RESULT[tag] == name, tag
    monkeypatch.setenv("EVOSORO_TPU_FUSED_EVAL", "1")
    for mod in (evaluation, j_evaluation):
        monkeypatch.setattr(mod, "_ladder_steps", lambda n: 64)
    sim_kw = dict(dt_frac=0.9, simulation_time=0.032, fitness_eval_init_time=0.004,
                  mid_life_freeze_time=0.01, self_collisions_enabled=False)
    # seed 4: one design with a needle and five feet among tissue and
    # counter-phased muscle, one with 15 needles, two all muscle
    kw = dict(seed=4, tissues=("1", "7"), muscles=("4", "6"), more_tags=_FEATURE_TAGS)
    pop_j = _population(JGenotype, JPhenotype, JPopulation, JCPPN, JObjectives,
                        j_material_tree, **kw)
    j_evaluation.evaluate_all(JSimC(**sim_kw), _features_env(JEnvC), pop_j)
    pop_p = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                        make_material_tree, **kw)
    evaluation.evaluate_all(Sim(**sim_kw), _features_env(Env), pop_p, device="cpu")
    assert [i.md5 for i in pop_p] == [i.md5 for i in pop_j]
    names = ["fitness"] + [f"tag{k}" for k in range(len(_FEATURE_TAGS))]
    got = np.array([[getattr(i, n) for n in names] for i in pop_p])
    want = np.array([[getattr(i, n) for n in names] for i in pop_j])
    assert np.isfinite(got).all()
    top = np.abs(want).max(axis=0)
    for k, name in enumerate(["<NormFinalDist>"] + list(_FEATURE_TAGS)):
        np.testing.assert_allclose(got[:, k], want[:, k], rtol=5e-3, atol=5e-3 * top[k],
                                   err_msg=name)
    # the robots walk (NormDistByVol, the frozen window's and the windows'
    # distances, divided by volumes of up to 64 voxels, reach 1e-6 to 4e-4),
    # a needle was pushed, every robot's end-of-life Y was captured
    for tag in ("<NormFinalDist>", "<NormFrozenDist>", "<PushDist>", "<WindowDist>"):
        assert top[(["<NormFinalDist>"] + list(_FEATURE_TAGS)).index(tag)] > 1e-6, tag
    assert (got[:, 1 + _FEATURE_TAGS.index("<FoundNeedleInHaystack>")] > 0.5).any()
    assert (got[:, 1 + _FEATURE_TAGS.index("<EndOfLifePosteriorY>")] > 0).all()


@pytest.mark.parametrize("tag", _EAGER_ONLY_TAGS)
def test_eager_only_tags_raise_by_name(tag):
    """The eight tags only the JAX package's eager evaluator fills raise,
    naming the tag, before anything is evaluated."""
    pop = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                      make_material_tree, tag=tag)
    with pytest.raises(NotImplementedError, match=tag):
        evaluation.evaluate_all(Sim(simulation_time=0.01), Env(), pop, device="cpu")
    assert tag in j_evaluation._OBJECTIVE_TAG_TO_RESULT
    assert tag not in evaluation._OBJECTIVE_TAG_TO_RESULT


def test_step_ladders_match_jax():
    for n in (1, 255, 256, 257, 300, 1000, 5000, 81000):
        assert evaluation._ladder_steps(n) == j_evaluation._ladder_steps(n)
    for m in range(1, 40):
        assert evaluation._ladder_count(m) == j_evaluation._ladder_count(m)


def test_write_vxa_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    structure = rng.integers(0, 5, size=(3, 4, 2)).astype(np.int32)
    phase = rng.uniform(-1, 1, size=(3, 4, 2))
    kw = dict(voxel_arrays={"PhaseOffset": phase}, fitness_file_name="f.xml")
    pj = j_write_vxa(os.path.join(tmp_path, "j.vxa"), structure,
                     j_default_palette(), sim=JSim(self_collisions_enabled=True),
                     env=JEnv(), **kw)
    pp = write_vxa(os.path.join(tmp_path, "p.vxa"), structure,
                   evosoro_default_palette(),
                   sim=SimParams(self_collisions_enabled=True), env=EnvParams(), **kw)
    assert open(pp).read() == open(pj).read()
