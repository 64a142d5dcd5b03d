"""Several devices and several processes: rollout batches sharded over a
mesh (an ordered list of devices, `mesh`) and one robot's lattice over
slabs (`spatial`); across processes, `torch.distributed`.

The reference's entire distributed backend is one OS process per individual
plus filesystem polling (reference: tools/evaluation.py:89-90, 101-211 —
SURVEY.md §2.4). Here the population and candidate parallelism is a batch
split over devices, with the results gathered on the first.
"""

from evosoro_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    distributed_init,
    make_mesh,
    replicate,
    scaling_report,
    shard_batch,
    sharded_fused_rollout,
    sharded_rollout_fn,
)
