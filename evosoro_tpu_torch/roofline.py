"""Roofline accounting of the port's kernels on one card.

The port of `tools/roofline.py`'s yardstick: `measure_fp32_peak` times the
hand-written multiply-add micro-kernel `ops/csrc/fma_peak.cu` (the twin of
the JAX tool's `measure_vpu_peak`) and returns the card's measured FP32
rate. Beside it, the least time the card could take for a launch of each
kernel (`bound`): the larger of its operations over the FP32 peak and its
compulsory bytes over the memory rate, from counts of the work the launch's
inputs need (`k1_work`, `b4_work`, `k2_work`, `fma_work`).

The step's operation count is static: 2187.028 per occupied voxel and step, the
`flop_count` of ROOFLINE.json (a jaxpr walk of the JAX package's `sim_step`
on the 10³ bench body that counts every elementwise operation, comparison
and select once and does not fuse multiply-adds). It is a count, not a time.
The adjoint's count comes from the same walk: 2640.005 per occupied voxel
and step is what the jaxpr of `jax.vjp` of that step (with the control
offset, forward pass and pullback together: 4829.033) holds beyond the
forward step itself (2189.028 with the control offset);
`tests/test_torch_roofline.py` repeats the walk.
"""

from __future__ import annotations

import numpy as np
import torch

from evosoro_tpu_torch.ops import build
from evosoro_tpu_torch.ops import fused_rollout as fr

# published peaks of one H100 SXM (NVIDIA's data sheet): FP32 outside the
# tensor cores, and the HBM3 rate
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

STEP_FLOPS_PER_VOXEL = 2187.028
ADJOINT_FLOPS_PER_VOXEL = 2640.005
# pair_contact.cuh: operations for every nonzero table entry (difference,
# distance, rsqrt, overlap test), and more for a pair that touches
PAIR_FLOPS_TESTED = 14
PAIR_FLOPS_TOUCHING = 8
# channels of the packed state and body that the envelope's step reads
# (state 0..46; body: 12 per voxel and 19 per direction)
K1_STATE_CHANNELS = 47
K1_BODY_CHANNELS = 12 + 3 * 19

CHAINS = 16
FMA_A = float(np.float32(1.0000001))
FMA_B = float(np.float32(1e-9))

FMA_PEAK_LAUNCHES = 0


def fma_chains_plain(x, iters: int):
    """Plain version of `fma_peak`, rounding as the kernel does: 16 chains
    from `x * c_k` (`c_k` the float32 `1 + 1e-7 k`), `iters` steps of
    `acc * a + b` worked in float64 and rounded to float32 at every step.
    The float64 product of two float32 values is exact, so a step rounds
    once, as a fused multiply-add does (the float64 sum can add a second
    rounding on a float32 tie, about once in 2^29 steps). The chains are
    summed in float32 in the kernel's order. x (N,) float32 -> (N,) float32."""
    c = np.float32(1) + np.float32(1e-7) * np.arange(CHAINS, dtype=np.float32)
    acc = x[None, :] * torch.as_tensor(c, device=x.device)[:, None]  # (16, N)
    for _ in range(iters):
        acc = (acc.to(torch.float64) * FMA_A + FMA_B).to(torch.float32)
    out = acc[0]
    for k in range(1, CHAINS):
        out = out + acc[k]
    return out


def fma_chains(x, iters: int):
    """`fma_peak` wrapper: x (N,) float32, contiguous -> (N,) sums of the 16
    chains. CUDA tensors launch the kernel; CPU tensors run
    `fma_chains_plain`."""
    if x.dim() != 1 or x.dtype != torch.float32:
        raise TypeError(f"x must be a float32 vector, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return fma_chains_plain(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    fn = build.library("fma_peak")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), int(iters),
                FMA_A, FMA_B, stream)
    build.check(rc, "fma_peak")
    global FMA_PEAK_LAUNCHES
    FMA_PEAK_LAUNCHES += 1
    return out


def fma_work(n: int, iters: int):
    """(flops, bytes) of one `fma_chains` call on n elements."""
    return 2.0 * CHAINS * iters * n, 8.0 * n


def measure_fp32_peak(iters: int = 65536, reps: int = 3, device="cuda") -> dict:
    """The card's measured FP32 multiply-add rate: `fma_peak` on a grid of
    four times the threads the card holds at once, timed with CUDA events
    over `reps` launches after a warm-up. Returns flops/s with the launch's
    size and milliseconds."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the FP32 peak is a measurement of the card: it "
                         "needs a CUDA device")
    props = torch.cuda.get_device_properties(device)
    n = props.multi_processor_count * 2048 * 4
    x = torch.ones(n, dtype=torch.float32, device=device)
    fma_chains(x, iters)
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fma_chains(x, iters)
    b.record()
    torch.cuda.synchronize(device)
    ms = a.elapsed_time(b) / reps
    flops, _ = fma_work(n, iters)
    return dict(flops_per_s=flops / (ms * 1e-3), ms=ms, threads=n, iters=iters,
                flops=flops)


def bound(flops: float, nbytes: float, fp32_flops: float = H100_FP32_FLOPS,
          bytes_per_s: float = H100_HBM_BYTES_PER_S) -> dict:
    """The least time the card could take: the larger of operations over the
    FP32 rate and bytes over the memory rate, and which of them it is."""
    t_ops = flops / fp32_flops
    t_bytes = nbytes / bytes_per_s
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def k1_work(state, body, stats, table, stats_out, controls=None):
    """(flops, bytes) that one K1 launch on these packed tensors needs.

    Steps are counted per robot from the time it advanced (a frozen robot
    leaves the loop): the static step count for every OCCUPIED voxel of the
    robot's body (an empty cell of the grid needs no work), and with contact
    the tested pairs of the robot's table (touching pairs do a few more
    operations that are not counted, so the bound stays a lower one). Bytes:
    the state channels the step uses in and out, the body channels it
    reads, the stats rows in and out, the pair table and the controls."""
    B, _, V = state.shape
    dt = stats[:, fr._S_DT]
    steps = torch.round((stats_out[:, fr._S_TIME] - stats[:, fr._S_TIME]) / dt)
    occupied = (body[:, fr._B_OCC, :] > 0.5).sum(1).to(steps.dtype)  # (B or 1,)
    flops = float((occupied * steps).sum()) * STEP_FLOPS_PER_VOXEL
    nbytes = 4.0 * (2 * B * K1_STATE_CHANNELS * V
                    + body.shape[0] * K1_BODY_CHANNELS * V
                    + 2 * stats.numel())
    if table is not None:
        nnz = (table != 0).flatten(1).sum(1).to(steps.dtype)  # (B or 1,)
        flops += float((nnz * steps).sum()) * PAIR_FLOPS_TESTED
        nbytes += 4.0 * table.numel()
    if controls is not None:
        nbytes += 4.0 * controls.numel()
    return flops, nbytes


def b4_work(state, body, stats, controls, steps):
    """(flops, bytes) that one B4 launch on these packed tensors needs.

    `steps` (B,) are the steps each robot's segment really took (a frozen
    robot's skipped steps are the identity). Operations: for every occupied
    voxel and step the forward recompute (`STEP_FLOPS_PER_VOXEL`) and the
    adjoint of the step (`ADJOINT_FLOPS_PER_VOXEL`). Bytes: what the
    function must move, whatever the kernel keeps in its tape: the start
    state's carried channels and the end state's cotangent in, the start
    state's cotangent out, the body channels the step reads, the stats rows,
    the controls in and their cotangent out."""
    B, _, V = state.shape
    steps = torch.as_tensor(steps, dtype=torch.float32, device=state.device)
    occupied = (body[:, fr._B_OCC, :] > 0.5).sum(1).to(steps.dtype)  # (B or 1,)
    flops = float((occupied * steps).sum()) * (
        STEP_FLOPS_PER_VOXEL + ADJOINT_FLOPS_PER_VOXEL)
    nbytes = 4.0 * (3 * B * K1_STATE_CHANNELS * V
                    + body.shape[0] * K1_BODY_CHANNELS * V
                    + stats.numel() + 2 * controls.numel())
    return flops, nbytes


def k2_work(pos, scale, a1):
    """(flops, bytes) that one K2 launch on these inputs needs: the tested
    pairs (nonzero table entries, for every robot) and the touching ones."""
    B, _, V = pos.shape
    p = pos.transpose(1, 2)
    dist = torch.cdist(p.double(), p.double())
    nom = 0.75 * (scale[:, :, None] + scale[:, None, :])
    tested = (a1 != 0).expand(B, V, V)
    touching = tested & (nom > dist)
    flops = float(tested.sum()) * PAIR_FLOPS_TESTED \
        + float(touching.sum()) * PAIR_FLOPS_TOUCHING
    nbytes = 4.0 * (pos.numel() + scale.numel() + a1.numel() + pos.numel())
    return flops, nbytes
