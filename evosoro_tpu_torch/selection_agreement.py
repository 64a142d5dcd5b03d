"""Kernel-vs-eager selection agreement on one population.

The twin of the JAX package's `tools/selection_agreement.py` (its record:
SELECTAGREE.json). K1 and the eager torch step follow the same physics in
another order of rounding, so at a production horizon a robot's two
trajectories part; what evolution needs is that SELECTION survives. This
evaluates the same population of evolved-shape walkers (the examples/
basic.py material tree, at least 20 voxels and 8 muscles) through K1 (the
evaluator's route) and through the eager evaluator (`_dispatch_batch(...,
eager=True)`), on one device, and reports the fitness rank agreement
(Spearman, Kendall), the top-k overlap and the largest fitness gap, with
each arm's wall time.

    python -m evosoro_tpu_torch.selection_agreement [--pop 32] [--size 10] [--time 5.0]

JAX's defaults (32 robots of 10^3, 5 s) are this module's; `--out PATH`
writes the record as JSON. `device` defaults to the card (`--device cpu`
runs the plain versions).
"""

from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np


def _rank(a):
    return np.argsort(np.argsort(a)).astype(np.float64)


def spearman(a, b):
    ra, rb = _rank(a), _rank(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else 1.0


def kendall(a, b):
    n = len(a)
    conc = disc = 0
    for i in range(n):
        for j in range(i + 1, n):
            s = np.sign(a[i] - a[j]) * np.sign(b[i] - b[j])
            if s > 0:
                conc += 1
            elif s < 0:
                disc += 1
    tot = n * (n - 1) // 2
    return float((conc - disc) / tot) if tot else 1.0


def _population(pop_size, size, seed):
    from evosoro_tpu_torch.evo.base import ObjectiveDict
    from evosoro_tpu_torch.evo.networks import CPPN
    from evosoro_tpu_torch.evo.softbot import Genotype, Phenotype, Population
    from evosoro_tpu_torch.utils.phenotype_mappers import make_material_tree

    class _Genotype(Genotype):
        def __init__(self):
            super().__init__(orig_size_xyz=(size, size, size))
            names = ["shape", "muscleOrTissue", "muscleType", "tissueType"]
            self.add_network(CPPN(output_node_names=names))
            m = self.to_phenotype_mapping
            m.add_map(name="material", tag="<Data>", func=make_material_tree,
                      dependency_order=names, output_type=int)
            m.add_output_dependency(name="shape", dependency_name=None, requirement=None,
                                    material_if_true=None, material_if_false="0")
            m.add_output_dependency(name="muscleOrTissue", dependency_name="shape",
                                    requirement=True, material_if_true=None,
                                    material_if_false=None)
            m.add_output_dependency(name="tissueType", dependency_name="muscleOrTissue",
                                    requirement=False, material_if_true="1",
                                    material_if_false="2")
            m.add_output_dependency(name="muscleType", dependency_name="muscleOrTissue",
                                    requirement=True, material_if_true="3",
                                    material_if_false="4")

    class _Phenotype(Phenotype):
        def is_valid(self):
            for name, details in self.genotype.to_phenotype_mapping.items():
                if np.isnan(details["state"]).any():
                    return False
                if name == "material":
                    state = details["state"]
                    if np.sum(state > 0) < 20 or np.sum((state == 3) | (state == 4)) < 8:
                        return False
            return True

    random.seed(seed)
    np.random.seed(seed)
    objectives = ObjectiveDict()
    objectives.add_objective(name="fitness", maximize=True, tag="<NormFinalDist>")
    objectives.add_objective(name="age", maximize=False, tag=None)
    return Population(objectives, _Genotype, _Phenotype, pop_size=pop_size)


def agreement(pop=32, size=10, sim_time=5.0, seed=17, collision=True, device=None,
              init_time=0.4):
    """The record: each arm's fitness and wall time, and their agreement;
    `init_time` is the fitness evaluation's start (JAX's 0.4 s)."""
    import torch

    from evosoro_tpu_torch.device import resolve_device
    from evosoro_tpu_torch.evo import evaluation
    from evosoro_tpu_torch.evo.base import Env, Sim
    from evosoro_tpu_torch.evo.logging import PrintLog

    device = resolve_device(device)
    sim = Sim(dt_frac=0.9, simulation_time=sim_time, fitness_eval_init_time=init_time)
    if not collision:
        sim.self_collisions_enabled = 0
    env = Env(time_between_traces=0)
    fits, wall, used_fused = {}, {}, {}
    for arm in ("kernel", "eager"):
        p = _population(pop, size, seed)
        p.already_evaluated = {}
        for ind in p:
            if not ind.phenotype.is_valid():
                for goal in p.objective_dict.values():
                    if goal["name"] != "age":
                        setattr(ind, goal["name"], goal["worst_value"])
        inds = [ind for ind in p if ind.phenotype.is_valid()]
        t0 = time.time()
        evaluation._dispatch_batch(sim, env, p, inds, PrintLog(), device=device,
                                   eager=arm == "eager")
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall[arm] = time.time() - t0
        used_fused[arm] = evaluation.LAST_DISPATCH_TIMING["used_fused"]
        fits[arm] = np.array([ind.fitness for ind in p], dtype=np.float64)
    assert used_fused == {"kernel": True, "eager": False}, used_fused
    valid = np.isfinite(fits["kernel"]) & np.isfinite(fits["eager"]) \
        & (fits["kernel"] > -1e6) & (fits["eager"] > -1e6)
    a, b = fits["kernel"][valid], fits["eager"][valid]
    order_a, order_b = np.argsort(-a), np.argsort(-b)
    return {
        "metric": "kernel_vs_eager_selection_agreement",
        "pop": pop,
        "valid": int(valid.sum()),
        "grid": [size] * 3,
        "sim_time_s": sim_time,
        "init_time_s": init_time,
        "self_collision": bool(collision),
        "device": str(device),
        "spearman": spearman(a, b),
        "kendall": kendall(a, b),
        "top_k_overlap": {str(k): int(len(set(order_a[:k]) & set(order_b[:k])))
                          for k in (4, 8)},
        "max_abs_fitness_delta": float(np.abs(a - b).max()) if len(a) else 0.0,
        "mean_abs_fitness_delta": float(np.abs(a - b).mean()) if len(a) else 0.0,
        "fitness_scale": float(np.abs(a).max()) if len(a) else 0.0,
        "wall_s": wall,
        "fitness_kernel": a.tolist(),
        "fitness_eager": b.tolist(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pop", type=int, default=32)
    ap.add_argument("--size", type=int, default=10)
    ap.add_argument("--time", type=float, default=5.0)
    ap.add_argument("--init-time", type=float, default=0.4)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--no-collision", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None, help="write the record here as JSON")
    args = ap.parse_args(argv)
    rec = agreement(pop=args.pop, size=args.size, sim_time=args.time, seed=args.seed,
                    collision=not args.no_collision, device=args.device,
                    init_time=args.init_time)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in ("spearman", "kendall", "top_k_overlap",
                                          "max_abs_fitness_delta", "wall_s")}))
    return rec


if __name__ == "__main__":
    main()
