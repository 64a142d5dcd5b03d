"""Several processes on one host: a generation and a spatial rollout split
over the ranks of a `torch.distributed` group, held against one process.

The twin of the JAX package's two-process check
(tests/test_distributed.py, tests/helpers/distributed_worker.py): each rank
runs `distributed_init`, evaluates its share of one generation of the basic
experiment through `evaluate_all` (the batch split over the ranks, the
metrics all-gathered, so every rank assigns the whole generation's
fitness) and its slab of one robot's spatial rollout, and writes what it
holds. `run_ranks` starts the ranks, waits for each with a hard time limit,
kills them all when it returns or fails, and raises if any rank failed.

    python -m evosoro_tpu_torch.parallel.ranks --world 2 --device cpu --backend gloo

Two ranks on one card take the gloo backend: NCCL refuses two ranks on
one GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the generation: a basic experiment's first population, cut in size and
# sim time, in launches of `batch_pad` blocks (a test's and a card check's;
# no result is a speed)
GENERATION = dict(pop_size=16, size=4, sim_time=0.004, init_time=0.001, batch_pad=8)
SPATIAL_STEPS = 6


def workload(device, generation=None, slabs=1, spatial_steps=SPATIAL_STEPS) -> dict:
    """Run the generation and the spatial rollout on `device` (split over
    the ranks when a process group is up; the lattice in `slabs` slabs a
    process): every fitness of the generation and the spatial rollout's
    final positions and distance, as lists."""
    import torch

    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body, calc_max_dt
    from evosoro_tpu_torch.core import evosoro_default_palette, palette_from_list
    from evosoro_tpu_torch.evo import evaluation
    from evosoro_tpu_torch.evo.logging import PrintLog
    from evosoro_tpu_torch.parallel.spatial import spatial_rollout

    g = dict(GENERATION, **(generation or {}))
    sim, env, pop = bench.basic_experiment(pop_size=g["pop_size"], sim_time=g["sim_time"],
                                           init_time=g["init_time"], size=(g["size"],) * 3)
    evaluation.evaluate_all(sim, env, pop, print_log=PrintLog(), devices=[device],
                            batch_pad=g["batch_pad"])
    fitness = [float(ind.fitness) for ind in pop]

    rng = np.random.default_rng(4)
    structure = rng.integers(0, 5, size=(8, 4, 3)).astype(np.int32)
    structure[:, 2, 0] = 3  # connected spine
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=rng.uniform(-1, 1, size=(8, 4, 3)),
                      dtype=torch.float64).to(device)
    sim2 = SimParams(init_cm_time=0.0)
    res = spatial_rollout(body, sim2, EnvParams(), spatial_steps,
                          float(calc_max_dt(body)) * sim2.dt_frac, [device] * slabs)
    return dict(fitness=fitness, n_shards=evaluation.LAST_DISPATCH_TIMING["n_shards"],
                spatial_pos=res.final_state.pos.cpu().numpy().ravel().tolist(),
                spatial_final_dist=float(res.final_dist))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(world: int = 2, device: str = "cpu", backend: str = "gloo",
              timeout: float = 120.0, generation=None) -> list:
    """Start `world` ranks of this module on `device` over `backend`, wait
    for each (at most `timeout` seconds in all), and return every rank's
    result in rank order. Kills every rank still running when it returns;
    raises if a rank failed or timed out, with its output."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "evosoro_tpu_torch.parallel.ranks", "--rank", str(r),
             "--world", str(world), "--address", f"127.0.0.1:{port}", "--backend", backend,
             "--device", device, "--out", os.path.join(tmp, f"rank{r}.json"),
             "--generation", json.dumps(generation or {})],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
        outs, deadline = [], time.monotonic() + timeout
        try:
            for p in procs:
                left = max(1.0, deadline - time.monotonic())
                outs.append(p.communicate(timeout=left)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"a rank ran past {timeout} s") from e
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(r, p.returncode, o[-3000:]) for r, (p, o) in enumerate(zip(procs, outs))
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("ranks failed: " + "\n".join(
                f"rank {r} exit {rc}:\n{o}" for r, rc, o in failed))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                results.append(json.load(f))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--address")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out")
    ap.add_argument("--generation", default="{}")
    args = ap.parse_args(argv)
    generation = json.loads(args.generation)
    if args.rank is None:  # the launcher: every rank against one process
        ranks = run_ranks(args.world, args.device, args.backend, generation=generation)
        one = workload(args.device, generation, slabs=args.world)
        same = all(r["fitness"] == one["fitness"] and r["spatial_pos"] == one["spatial_pos"]
                   for r in ranks)
        print(json.dumps(dict(ranks_equal_one_process=same, n_shards=ranks[0]["n_shards"])))
        return 0 if same else 1

    import torch
    import torch.distributed as dist

    from evosoro_tpu_torch.parallel.mesh import distributed_init

    if args.device == "cpu":
        torch.set_num_threads(1)
    distributed_init(backend=args.backend, coordinator_address=args.address,
                     num_processes=args.world, process_id=args.rank)
    try:
        out = workload(args.device, generation)
    finally:
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
