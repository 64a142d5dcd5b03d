"""The port's evolution layer held against the JAX package on the CPU: twin
populations seeded identically get the same NormFinalDist from both
`evaluate_all`s, and the archived VXA files are byte-identical."""

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
from evosoro_tpu.utils.phenotype_mappers import make_material_tree as j_material_tree
from evosoro_tpu_torch.core.types import EnvParams, SimParams, evosoro_default_palette
from evosoro_tpu_torch.evo import evaluation
from evosoro_tpu_torch.evo.base import Env, ObjectiveDict, Sim
from evosoro_tpu_torch.evo.networks import CPPN
from evosoro_tpu_torch.evo.softbot import Genotype, Phenotype, Population
from evosoro_tpu_torch.io.vxa import write_vxa
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
    pop = _population(Genotype, Phenotype, Population, CPPN, ObjectiveDict,
                      make_material_tree,
                      tag="<PosteriorY>" if what == "objective" else "<NormFinalDist>")
    if what == "devo":
        for ind in pop:
            ind.genotype.add_network(CPPN(output_node_names=["growth"]))
            ind.genotype.to_phenotype_mapping.add_map(
                name="growth", tag="<FinalVoxelSize>", output_type=float)
            ind.genotype.express()
    with pytest.raises(NotImplementedError):
        evaluation.evaluate_all(Sim(simulation_time=0.01), Env(), pop, device="cpu")


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
