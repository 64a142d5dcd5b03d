"""Two processes through `torch.distributed` (gloo, on the CPU), the twin of
tests/test_distributed.py: `parallel.ranks` starts two ranks, each runs
`parallel.mesh.distributed_init` and its share of one generation of the
basic experiment through `evaluate_all` (the batch split over the ranks,
the metrics all-gathered) and its slab of one robot's spatial rollout (the
halo all-gathered). Every rank's gathered fitness and final positions must
equal one process's, bit for bit. Each rank has a hard time limit and is
killed when the test ends.
"""

import pytest
import torch

from evosoro_tpu_torch.evo import evaluation
from evosoro_tpu_torch.parallel import ranks

torch.set_num_threads(1)


# 8 robots in blocks of 4: one shard a rank
GENERATION = dict(pop_size=8, batch_pad=4)


def test_two_process_generation_matches_single():
    got = ranks.run_ranks(world=2, device="cpu", backend="gloo", timeout=120,
                          generation=GENERATION)
    one = ranks.workload("cpu", GENERATION, slabs=2)
    assert len(got) == 2
    for r in got:
        assert r["n_shards"] == 2  # one shard a rank
        assert r["fitness"] == one["fitness"]
        assert r["spatial_pos"] == one["spatial_pos"]
        assert r["spatial_final_dist"] == one["spatial_final_dist"]
    assert any(f != 0 for f in one["fitness"])
    assert evaluation.LAST_DISPATCH_TIMING["n_shards"] == 1


def test_a_failing_rank_fails_the_run():
    """A rank that cannot run (a device that does not exist) fails the
    whole run with its output; no rank is left running."""
    with pytest.raises(RuntimeError, match="rank 0 exit"):
        ranks.run_ranks(world=2, device="nodevice", backend="gloo", timeout=60)
