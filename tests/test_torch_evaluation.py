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
                material_tree, seed=11, tag="<NormFinalDist>"):
    """The examples/basic.py material-tree genome at 4³, pop 4."""

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
                                    material_if_false="2")
            m.add_output_dependency(name="muscleType", dependency_name="muscleOrTissue",
                                    requirement=True, material_if_true="3",
                                    material_if_false="4")

    class _Phenotype(Phenotype_):
        def is_valid(self):
            state = self.genotype.to_phenotype_mapping["material"]["state"]
            return np.sum(state > 0) >= 4 and np.sum((state == 3) | (state == 4)) >= 2

    random.seed(seed)
    np.random.seed(seed)
    objectives = Objectives_()
    objectives.add_objective(name="fitness", maximize=True, tag=tag)
    objectives.add_objective(name="age", maximize=False, tag=None)
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
    state, body, stats, table = fn.pack(*inputs)
    structures = inputs[0]
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
    """Ballistic development (a final size evolved under speed windows) and
    fitness tags beyond NormFinalDist / finalDistY still raise, by name."""
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
    with pytest.raises(NotImplementedError,
                       match="ballistic|window" if what == "devo" else "objective tag"):
        evaluation.evaluate_all(Sim(simulation_time=0.01), env, pop, device="cpu")


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
