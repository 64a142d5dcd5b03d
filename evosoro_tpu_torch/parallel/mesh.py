"""Sharding rollout batches over several devices and several processes.

The port of `evosoro_tpu.parallel.mesh`. The reference's "distributed
backend" is one OS process per individual plus filesystem polling
(reference: tools/evaluation.py:89-90, 101-211). The JAX package shards the
batch over a `Mesh` inside one controller and across hosts with
`jax.distributed`. The port keeps that shape in PyTorch's idiom:

- in one process a mesh is an ordered list of torch devices (`Mesh`). Each
  entry holds one shard of the batch and gets its own launch, issued
  without waiting: a K1 launch enters its tensors' device and takes that
  device's current stream. The results are gathered on the first entry's
  device. An entry may name a device more than once (a card split in
  several shards), which JAX's `Mesh` does not allow;
- across processes, `torch.distributed` (`distributed_init`, with the
  backend the caller names: NCCL across cards, gloo on the CPU and for
  ranks that share one card). Under an initialized process group the
  sharded functions split the batch over the ranks, each rank over its own
  mesh, and all-gather the results, so every rank holds the whole batch's.

The `axis_name` arguments are kept for the JAX package's signatures; a
device list has one axis.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices, one shard of a batch each (a device may
    repeat); `axis_name` is kept for the JAX package's signatures."""

    devices: tuple
    axis_name: str = "rollout"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    def __len__(self):
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, i):
        return self.devices[i]


def as_mesh(mesh) -> Mesh:
    """`mesh` as a `Mesh`: a `Mesh`, or a sequence of devices (torch
    devices or their names). Anything else raises by name."""
    if isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, (list, tuple)) and mesh and all(
            isinstance(d, (str, torch.device)) for d in mesh):
        return Mesh(tuple(mesh))
    raise TypeError(
        f"mesh must be a parallel.mesh.Mesh or a non-empty sequence of devices, "
        f"not {type(mesh).__name__}")


def check_mesh(mesh: Mesh, device) -> Mesh:
    """Refuse a mesh entry of another device type than `device`'s, the
    device the path was asked to run on (the card unless the caller names
    the CPU): no shard falls back to another device."""
    device = torch.device(device)
    for d in mesh:
        if d.type != device.type:
            raise ValueError(f"mesh entry {d} is not a {device.type} device, and this "
                             f"path runs on {device}")
    return mesh


def distributed_init(backend=None, coordinator_address=None, num_processes=None,
                     process_id=None, device=None):
    """Start the default process group (`torch.distributed`) for
    `num_processes` ranks; a no-op for one process, as in the JAX package.
    `coordinator_address` is `host:port` of rank 0 (`tcp://` is added);
    `backend` is the caller's: "nccl" across cards, "gloo" on the CPU and
    for ranks that share one card (NCCL refuses two ranks on one GPU);
    None lets torch pick. `device`, a CUDA device, becomes the rank's
    current device (NCCL's collectives use it)."""
    import torch.distributed as dist

    if num_processes is None or int(num_processes) <= 1:
        return
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))


def process_split() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def allgather_objects(obj) -> list:
    """Every rank's `obj`, in rank order (picklable objects; tensors are
    moved to the host first, so gloo and NCCL both carry them)."""
    import torch.distributed as dist

    rank, world = process_split()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, tree_map(lambda t: t.cpu(), obj))
    return out


def make_mesh(devices: Sequence | None = None, axis_name: str = "rollout") -> Mesh:
    """A mesh over the given devices, or over every visible card. Without a
    card and without `devices` this raises: pass `devices=["cpu"] * n` for
    the plain versions."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found: pass devices= (for example "
                               '["cpu"] * n) to shard over the CPU')
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return Mesh(tuple(devices), axis_name)


# ---------------------------------------------------------------------------
# Trees of tensors (dataclasses, tuples, lists, dicts)
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """`fn` over every tensor leaf of `tree` (and the matching leaves of
    `rest`); other leaves pass through from `tree`."""
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return tree


def _leading(tree) -> int:
    sizes = set()
    tree_map(lambda t: sizes.add(t.shape[0]) if t.dim() else None, tree)
    if len(sizes) != 1:
        raise ValueError(f"batch leaves disagree on their leading size: {sorted(sizes)}")
    return sizes.pop()


def row_spans(B: int, n: int, exact: bool = True) -> list:
    """The (lo, hi) rows of n contiguous shards of B rows, in shard order:
    equal shards (B must divide by n), or with `exact=False` shards as
    equal as whole rows allow."""
    if exact and B % n:
        raise ValueError(f"{B} rows do not divide by {n} shards")
    return [(i * B // n, (i + 1) * B // n) for i in range(n)]


def run_shards(launch: Callable, spans: Sequence, devices: Sequence, owners=None,
               fetch: Callable | None = None) -> list:
    """The split-launch-gather rule of every sharded path. Shard k is the
    rows `spans[k]` on `devices[k]`: `launch(lo, hi, device)` runs it, every
    launch of this process issued before any result is read, then `fetch`
    (a copy to the host, say) of each result. `owners[k]` is the rank that
    runs shard k: the other ranks' results are all-gathered. With `owners`
    None this process runs every shard. Returns the results in shard
    order."""
    if owners is None:
        launched = [launch(lo, hi, d) for (lo, hi), d in zip(spans, devices)]
        return [fetch(x) for x in launched] if fetch else launched
    rank = process_split()[0]
    launched = [launch(lo, hi, d) for (lo, hi), d, r in zip(spans, devices, owners)
                if r == rank]
    local = [fetch(x) for x in launched] if fetch else launched
    return [x for got in allgather_objects(local) for x in got]


def rank_shards(devices: Sequence) -> tuple[list, list]:
    """(owners, devices) of every rank's entries in rank order, each rank
    giving a device list of the same size (one rank: its own)."""
    world = process_split()[1]
    return ([r for r in range(world) for _ in devices],
            [d for _ in range(world) for d in devices])


def shard_batch(tree: Any, mesh, axis_name: str = "rollout") -> list:
    """A tree of batch-leading tensors split along dim 0 into one shard an
    entry of `mesh`, each on its device (the batch must divide by the mesh's
    size). Returns the list of shards."""
    mesh = as_mesh(mesh)
    return [tree_map(lambda t, lo=lo, hi=hi, d=d: t[lo:hi].to(d).contiguous(), tree)
            for (lo, hi), d in zip(row_spans(_leading(tree), len(mesh)), mesh)]


def replicate(tree: Any, mesh) -> list:
    """A copy of `tree` (a VoxelBody, say) on every entry's device; entries
    naming the same device share one copy."""
    mesh = as_mesh(mesh)
    copies = {d: tree_map(lambda t, d=d: t.to(d), tree) for d in set(mesh)}
    return [copies[d] for d in mesh]


def gather(shards: list, device) -> Any:
    """The shards' trees concatenated along dim 0 on `device`; leaves without
    a batch dim are taken from the first shard."""
    return tree_map(lambda *ts: torch.cat([t.to(device) for t in ts])
                    if ts[0].dim() else ts[0].to(device), *shards)


def _device_of(tree) -> torch.device:
    found = []
    tree_map(lambda t: found.append(t.device), tree)
    return found[0]


def run_sharded(fn: Callable, tree: Any, mesh, *args) -> Any:
    """`fn(shard, *shard_args)` on each entry's shard of the batch-leading
    `tree`, each call issued without waiting; the results gathered on the
    first entry's device. `args` are replicated on every entry's device.
    The entries must be devices of the batch's type. Under a process group
    each rank takes its rows of the batch and the results are all-gathered
    in rank order."""
    mesh = check_mesh(as_mesh(mesh), _device_of(tree))
    owners, devices = rank_shards(mesh)
    on = {d: tree_map(lambda t, d=d: t.to(d), args) for d in set(mesh)}

    def launch(lo, hi, d):
        return fn(tree_map(lambda t: t[lo:hi].to(d).contiguous(), tree), *on[d])

    spans = row_spans(_leading(tree), len(devices))
    return gather(run_shards(launch, spans, devices, owners), mesh[0])


def sharded_rollout_fn(rollout_fn: Callable, mesh, axis_name: str = "rollout"):
    """`rollout_fn(batched_state) -> result` with the batch split over the
    mesh (and the ranks): one call a shard, the results gathered."""
    mesh = as_mesh(mesh)
    return lambda batched_state: run_sharded(rollout_fn, batched_state, mesh)


def sharded_fused_rollout(batched_state, body, sim, env, num_steps: int, dt, mesh,
                          axis_name: str = "rollout", stop_time=None):
    """The fused rollout (`ops.fused_rollout.fused_rollout`) data-parallel
    over a mesh of the batch's device type: each entry runs one K1 launch
    over its shard of the batch (on the CPU the plain version), with the
    body replicated on its device. Returns (new_state, FastRolloutStats)
    gathered on the first entry's device; K1's results for a robot do not
    depend on the other robots of its launch, so they equal one launch over
    the whole batch."""
    from evosoro_tpu_torch.ops.fused_rollout import fused_rollout

    def local(state, body_d):
        return fused_rollout(state, body_d, sim, env, num_steps=num_steps, dt=dt,
                             stop_time=stop_time)

    return run_sharded(local, batched_state, mesh, body)


def _synchronize(mesh: Mesh):
    for d in set(mesh):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def scaling_report(fn: Callable, make_batch: Callable[[int], Any],
                   device_counts: Sequence[int] | None = None, reps: int = 3,
                   axis_name: str = "rollout", devices: Sequence | None = None) -> dict:
    """Weak scaling over growing device lists: for d entries a batch
    `make_batch(d)` (the caller sizes it d times one entry's) runs through
    `sharded_rollout_fn(fn, ...)` over the first d of `devices` (every
    visible card by default). Returns {d: items per second} and
    "efficiency" {d: rate / (d x rate at 1)}."""
    all_devices = list(make_mesh(devices))
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(all_devices)]
    results = {}
    for d in device_counts:
        mesh = Mesh(tuple(all_devices[:d]), axis_name)
        batch = make_batch(d)
        run = sharded_rollout_fn(fn, mesh)
        run(batch)  # warm
        _synchronize(mesh)
        t0 = time.perf_counter()
        for _ in range(reps):
            run(batch)
        _synchronize(mesh)
        results[d] = _leading(batch) / ((time.perf_counter() - t0) / reps)
    if 1 in results:
        results["efficiency"] = {d: results[d] / (d * results[1])
                                 for d in device_counts if d != 1}
    return results
