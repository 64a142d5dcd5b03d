"""Roofline accounting of the port's kernels on one card.

The port of `tools/roofline.py`'s yardstick: `measure_fp32_peak` times the
hand-written multiply-add micro-kernel `ops/csrc/fma_peak.cu` (the twin of
the JAX tool's `measure_vpu_peak`) and returns the card's measured FP32
rate. Beside it, the least time the card could take for a launch of each
kernel (`bound`): the larger of its operations over the FP32 peak and its
compulsory bytes over the memory rate, from counts of the work the launch's
inputs need (`k1_work`, `b7_work`, `b8_work`, `b4_work` in each variant
and its material instance, `k2_work`,
`b5_work`, `b5_pass_work`, `b6_work`, `b6d_work`, `fma_work`; `launch_work` picks K1's by
the launch's flags).

The step's operation count is static: 2187.028 per occupied voxel and step, the
`flop_count` of ROOFLINE.json (a jaxpr walk of the JAX package's `sim_step`
on the 10³ bench body that counts every elementwise operation, comparison
and select once and does not fuse multiply-adds). It is a count, not a time.
The adjoint's count comes from the same walk: 2640.005 per occupied voxel
and step is what the jaxpr of `jax.vjp` of that step (with the control
offset, forward pass and pullback together: 4829.033) holds beyond the
forward step itself (2189.028 with the control offset);
`tests/test_torch_roofline.py` repeats the walk.

The fluid and development steps are counted by the same walk on the same
body: 2176.022 for the step in water with the voxel-face drag, 2218.032 for
the land step with the growth experiment's development fields (initial and
final size, growth time and its start). The facet-drag step's count depends
on the body's surface: over three 10³ bodies with different surfaces the
walk of the JAX step with its gather tables is exactly 2124.023 per grid
voxel + 48 per surface triangle + 612 per surface vertex, and a fourth body
confirms it. Those tables pad every vertex to 8 corner slots and multiply the
padding by zero; a walk with the tables cut to 4 and to 2 slots splits the
612 into 76 per slot and 4 per vertex. A vertex of a surface has 1 to 7
occupied voxels around it, and only those corners need rotating, so the bound
counts 76 for each of them (`mesh_counts`), not for each slot.

The fitness features are counted by walks of the JAX package's functions
that compute them, on the same body, per grid voxel: a trace sample (CoM and
volume, `center_of_mass` and `total_volume`) 11.004, the fall-over latch's
touch counts (`_touch_counts`) 8, the end-of-life posterior Y (`_posterior_y`)
4, the needle's position (`_needle_pos`) 5.004, one source's distances
(`min_distances` of `source_positions`) 10.017, and the ballistic rebase
18.013 (its `sim_step` with a DevoState less without). Each counts where the
launch's data needs it (`b8c_work`, `b8d_work`, `b8b_work`): a sample for
every trace the robot took, the latch on every step past its InitCmTime, a
capture once, the sources and the rebase on every step.

The material instance (`b6_work`) is counted by the same walk of the JAX
step on the same body with each option on, beyond the land step, per
occupied voxel and step: the nonlinear stress with the stress-equalization
loop 294 (a bilinear palette), plasticity 18, the max-velocity clamp 14 and
1 a robot, equilibrium mode 5 a robot (the ring's test); the JAX step
applies its BC arrays whether or not a region is set, so the land count
holds them and BC regions add none. The MDL_DATA lookup is counted as the
kernel does it, not as the walk (whose one-hot select over every point of
the table adds 270 a point and voxel: the TPU's way to index): a curve
evaluation at a voxel with an MDL_DATA material walks the table's P - 2
inner points with a compare and an add each (`MDL_FLOPS_PER_POINT`) and
interpolates (`MDL_FLOPS_PER_LOOKUP`: the segment's slope and value, the
line past failure, the test and the select); a homogeneous bond evaluates
its curve once, any other bond each side's four times (the first stress and
the three equalization rounds), counted from the launch's bonds
(`mdl_lookups`). The surface-compacted contact pass (`b5_work`) is the dense
pass's field over the S surface voxels: a walk of
`_pair_contact_forces_compact` on (S, S) beside one of `_pair_contact_forces`
on an S-voxel grid gives the same count, the one-hot gather and scatter
products aside (on this card an index load, no operation), and the kernel
runs K2's loop body; so the bound charges `PAIR_FLOPS_TESTED` for every
nonzero entry of the compact table, as `k1_work` does for the dense one.

The adjoint in water and with growth (`b4_work` on a fluid or development
launch) is counted by the same walk of `jax.vjp` of the JAX step with the
control offset, less the forward step, on the same bodies: 2659.005 per
occupied voxel and step in water with the voxel-face drag, 2671.007 with
the growth experiment's development fields; with the facet drag, over the
four bodies of the forward count, exactly 2630.005 per grid voxel + 58 per
surface triangle + 507 per surface vertex, whose vertex part a walk of the
vjp of `mesh_drag_forces` with the tables cut to 4 and 2 slots splits into
63 per corner slot and 3 per vertex; the bound counts the 63 for each live
corner, as for the forward step.

The adjoint on a bilinear palette and with the max-velocity clamp (`b4_work`
on a land launch with `nonlinear` or `max_vel`, B4's material instance) is
counted by the same walk of `jax.vjp` of the JAX step with the control
offset, less the forward step, on the 10^3 bench body: beyond the land
adjoint, 213 per occupied voxel and step for the nonlinear stress (the
muscles of `bench.bilinear_palette`: bilinear, yielding at 2 % strain) and
22 for the clamp, with no part a robot; the two add (235 with both), and a
6^3 body gives the same. The launch also recomputes the forward step with
the same options, so it adds the forward counts above (294, 14 and 1 a
robot).

Bodies past one block's shared memory (12^3, 13^3 and larger) are bound by
the same counts: K1's and B4's device-memory instances do the work of the
shared ones. Their compulsory bytes are the same inputs and outputs, with
contact the dense (V, V) pair table among them (11.9 MB a robot at 12^3,
19.3 MB at 13^3), read once: a kernel that keeps it nowhere reads it again
every step, which is a design's traffic, as is the buffer the instance
keeps in device memory (~43.4 floats a voxel with contact); neither is
compulsory.

The dense pass's count is the function's work, whatever implements it:
`PAIR_FLOPS_TESTED` for every nonzero entry of the table every step, and
the table's bytes once a launch. The pass of `ops/csrc/pair_contact.cuh`
skips 32 x 32 tiles that hold no nonzero entry or whose voxels lie too far
apart to touch, and evaluates every pair of the others, zero entries
included; `chip_smoke.py` prints the tiles it evaluates beside the bound
(`fused_rollout.pair_tile_census_plain` counts them on the CPU).

Volume effects (`b6d_work`) are counted by the same walk of the JAX step
with VolumeEffectsEnabled on (and its carry in the state) beyond the land
step, with `EnvParams()`'s varying temperature as the thermal term's clock:
194 per occupied voxel and step (the Poisson-coupled stress, the thermal
term, k_eff of every bond, the voxel pass's coupling with its transverse
contractions) and 19 a robot and step (the max, the square root and the
division of the new dt); walks of 6³, 8³ and 10³ bodies fit that split
exactly. Under volume effects the dt changes every step, so a launch's steps
are counted from its step count (`volume_clock`), not from its clock.
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
FLUID_FACE_STEP_FLOPS_PER_VOXEL = 2176.022
FLUID_MESH_STEP_FLOPS_PER_VOXEL = 2124.023  # the step in water without a drag model
MESH_FLOPS_PER_TRIANGLE = 48.0
MESH_FLOPS_PER_CORNER = 76.0  # one occupied voxel's corner at a vertex
MESH_FLOPS_PER_VERTEX = 4.0
MESH_TABLE_SLOTS = 8  # corner slots a vertex of the gather tables is padded to
DEVO_STEP_FLOPS_PER_VOXEL = 2218.032
# the adjoint of the step beyond the step, per occupied voxel (or, with the
# facet drag, per surface triangle, corner and vertex), in water and with
# development (module docstring)
FLUID_FACE_ADJOINT_FLOPS_PER_VOXEL = 2659.005
FLUID_MESH_ADJOINT_FLOPS_PER_VOXEL = 2630.005
MESH_ADJOINT_FLOPS_PER_TRIANGLE = 58.0
MESH_ADJOINT_FLOPS_PER_CORNER = 63.0
MESH_ADJOINT_FLOPS_PER_VERTEX = 3.0
DEVO_ADJOINT_FLOPS_PER_VOXEL = 2671.007
# ... and on land beyond the land adjoint, with a bilinear palette and with
# the max-velocity clamp (module docstring)
NONLINEAR_ADJOINT_FLOPS_PER_VOXEL = 213.0
MAX_VEL_ADJOINT_FLOPS_PER_VOXEL = 22.0
# the fitness features, per occupied voxel (module docstring)
TRACE_SAMPLE_FLOPS_PER_VOXEL = 11.004
FALL_LATCH_FLOPS_PER_VOXEL = 8.0
EOL_POSTERIOR_FLOPS_PER_VOXEL = 4.0
NEEDLE_FLOPS_PER_VOXEL = 5.004
SOURCE_FLOPS_PER_VOXEL = 10.017  # one source, one step
BALLISTIC_FLOPS_PER_VOXEL = 18.013  # one step
# the material instance, per occupied voxel and step (module docstring)
NONLINEAR_FLOPS_PER_VOXEL = 294.0
# one MDL_DATA curve evaluation: each inner point of the table, and the rest
MDL_FLOPS_PER_POINT = 2.0
MDL_FLOPS_PER_LOOKUP = 13.0
PLASTIC_FLOPS_PER_VOXEL = 18.0
MAX_VEL_FLOPS_PER_VOXEL = 14.0
MAX_VEL_FLOPS_PER_STEP = 1.0  # a robot
EQUILIBRIUM_FLOPS_PER_STEP = 5.0  # a robot
VOLUME_FLOPS_PER_VOXEL = 194.0
VOLUME_FLOPS_PER_STEP = 19.0  # a robot
# what volume effects read beyond the land step: of the body Young's modulus,
# Poisson's ratio and the material temperature phase; of the state the side
# means of the transverse strain sums and cross-sections, read and written
VOLUME_BODY_CHANNELS = 3
VOLUME_STATE_CHANNELS = 6
BC_CHANNELS = 15
MATERIAL_BODY_CHANNELS = 4  # Young's modulus, model, plastic modulus, yield stress
# the dense pair pass: operations for every nonzero table entry
# (difference, distance, rsqrt, overlap test), and more for a pair that
# touches
PAIR_FLOPS_TESTED = 14
PAIR_FLOPS_TOUCHING = 8
# channels of the packed state and body that the envelope's step reads
# (state 0..46; body: 12 per voxel and 19 per direction)
K1_STATE_CHANNELS = 47
K1_BODY_CHANNELS = 12 + 3 * 19
K1_DEVO_BODY_CHANNELS = 6  # sizes, growth window, final phase and damping

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


def steps_taken(stats, stats_out):
    """(B,) steps each robot of a launch advanced, from its clock."""
    dt = stats[:, fr._S_DT]
    return torch.round((stats_out[:, fr._S_TIME] - stats[:, fr._S_TIME]) / dt)


def mesh_counts(occ):
    """(triangles (B,), vertices (B,), corners (B,)) of the surface meshes of
    the bodies `occ` (B, X, Y, Z) bool: two triangles for every face of an
    occupied voxel without a neighbour, the corner-lattice points those faces
    touch, and the occupied voxels around those points, each of which gives
    the vertex one corner to average (the tables of
    `envs.drag.build_mesh_drag`: rows of `vert_vox`, and its live slots)."""
    B, X, Y, Z = occ.shape
    padded = torch.nn.functional.pad(occ, (1, 1, 1, 1, 1, 1))
    # occupied voxels around every corner-lattice point
    around = sum(padded[:, a:a + X + 1, b:b + Y + 1, c:c + Z + 1].to(torch.int64)
                 for a in (0, 1) for b in (0, 1) for c in (0, 1))
    corner = torch.zeros((B, X + 1, Y + 1, Z + 1), dtype=torch.bool, device=occ.device)
    tris = torch.zeros(B, dtype=torch.int64, device=occ.device)
    dims = (X, Y, Z)
    for axis in range(3):
        for sign in (1, -1):
            sl = [slice(None)] + [slice(1, d + 1) for d in dims]
            sl[1 + axis] = slice(1 + sign, dims[axis] + 1 + sign)
            exposed = occ & ~padded[tuple(sl)]
            tris += 2 * exposed.flatten(1).sum(1)
            others = [a for a in range(3) if a != axis]
            for da in (0, 1):
                for db in (0, 1):
                    at = [slice(None)] + [slice(0, d) for d in dims]
                    at[1 + axis] = slice((sign + 1) // 2, dims[axis] + (sign + 1) // 2)
                    at[1 + others[0]] = slice(da, dims[others[0]] + da)
                    at[1 + others[1]] = slice(db, dims[others[1]] + db)
                    corner[tuple(at)] |= exposed
    return tris, corner.flatten(1).sum(1), (around * corner).flatten(1).sum(1)


def k1_work(state, body, stats, table, stats_out, controls=None,
            flops_per_voxel=STEP_FLOPS_PER_VOXEL, extra_body_channels=0,
            flops_per_step=None):
    """(flops, bytes) that one K1 launch on these packed tensors needs.

    Steps are counted per robot from the time it advanced (a frozen robot
    leaves the loop): the static step count for every OCCUPIED voxel of the
    robot's body (an empty cell of the grid needs no work), and with contact
    the tested pairs of the robot's table (touching pairs do a few more
    operations that are not counted, so the bound stays a lower one). Bytes:
    the state channels the step uses in and out, the body channels it
    reads, the stats rows in and out, the pair table and the controls."""
    B, _, V = state.shape
    steps = steps_taken(stats, stats_out)
    occupied = (body[:, fr._B_OCC, :] > 0.5).sum(1).to(steps.dtype)  # (B or 1,)
    flops = float((occupied * steps).sum()) * flops_per_voxel
    if flops_per_step is not None:  # (B or 1,) more operations a step
        flops += float((flops_per_step.to(steps.dtype) * steps).sum())
    nbytes = 4.0 * (2 * B * K1_STATE_CHANNELS * V
                    + body.shape[0] * (K1_BODY_CHANNELS + extra_body_channels) * V
                    + 2 * stats.numel())
    if table is not None:
        nnz = (table != 0).flatten(1).sum(1).to(steps.dtype)  # (B or 1,)
        flops += float((nnz * steps).sum()) * PAIR_FLOPS_TESTED
        nbytes += 4.0 * table.numel()
    if controls is not None:
        nbytes += 4.0 * controls.numel()
    return flops, nbytes


def b7_work(state, body, stats, table, stats_out, grid_shape, mesh=True):
    """(flops, bytes) of one K1 launch in a fluid environment. With the
    voxel-face model every occupied voxel and step takes
    `FLUID_FACE_STEP_FLOPS_PER_VOXEL`; with the facet drag (`mesh`) the step
    takes `FLUID_MESH_STEP_FLOPS_PER_VOXEL` and the robot's surface mesh
    `MESH_FLOPS_PER_TRIANGLE`, `MESH_FLOPS_PER_VERTEX` and
    `MESH_FLOPS_PER_CORNER` for each of its triangles, its vertices and the
    occupied corners that meet in them (`mesh_counts` of the robot's own
    body). Bytes as `k1_work`: the strains' scratch is the kernel's own
    business."""
    if not mesh:
        return k1_work(state, body, stats, table, stats_out,
                       flops_per_voxel=FLUID_FACE_STEP_FLOPS_PER_VOXEL)
    X, Y, Z = grid_shape
    tris, verts, corners = mesh_counts(
        body[:, fr._B_OCC, :].reshape(-1, X, Y, Z) > 0.5)
    per_step = (MESH_FLOPS_PER_TRIANGLE * tris + MESH_FLOPS_PER_VERTEX * verts
                + MESH_FLOPS_PER_CORNER * corners)
    return k1_work(state, body, stats, table, stats_out,
                   flops_per_voxel=FLUID_MESH_STEP_FLOPS_PER_VOXEL,
                   flops_per_step=per_step)


def b8_work(state, body, stats, table, stats_out):
    """(flops, bytes) of one K1 launch on development bodies: the land
    step with the growth ramps, `DEVO_STEP_FLOPS_PER_VOXEL` per occupied
    voxel and step, and the body's six development channels more to read."""
    return k1_work(state, body, stats, table, stats_out,
                   flops_per_voxel=DEVO_STEP_FLOPS_PER_VOXEL,
                   extra_body_channels=K1_DEVO_BODY_CHANNELS)


def b5_work(table, stats, stats_out):
    """(flops, bytes) of the surface-compacted contact pass in one K1
    launch: `PAIR_FLOPS_TESTED` for every nonzero entry of each robot's
    compact table (B or 1, S + 1, S) on every step the robot took (touching
    pairs do a few more, not counted, as in `k1_work`); bytes, the table."""
    steps = steps_taken(stats, stats_out)
    nnz = (table[:, 1:] != 0).flatten(1).sum(1).to(steps.dtype)  # (B or 1,)
    return float((nnz * steps).sum()) * PAIR_FLOPS_TESTED, 4.0 * table.numel()


def mdl_lookups(body, grid_shape):
    """(B or 1,) MDL_DATA curve evaluations a step of the bodies `body`
    (B or 1, C_B, V) on `grid_shape`: for every bond, its first voxel's
    once if the bond is homogeneous, else four times at each voxel of the
    bond that has an MDL_DATA material (module docstring)."""
    X, Y, Z = grid_shape
    mdl = body[:, fr._B_MATMODEL, :] == 3.0  # MDL_DATA
    count = torch.zeros(body.shape[0], dtype=torch.float64, device=body.device)
    for d, stride in enumerate((Y * Z, Z, 1)):
        ch = fr._B_DIR + d * fr._B_PER_DIR
        bond = body[:, ch + fr._D_MASK, :] > 0.5
        hom = body[:, ch + fr._D_HOM, :] > 0.5
        # a bond's second voxel lies `stride` further; a bond never wraps
        other = torch.roll(mdl, -stride, dims=1)
        n = torch.where(hom, mdl.double(), 4.0 * (mdl.double() + other.double()))
        count += (n * bond).sum(1)
    return count


def b6_work(body, stats, stats_out, flags, grid_shape, n_pts=0):
    """(flops, bytes) the material instance's options add to one K1 launch
    (module docstring): for every occupied voxel and step the nonlinear
    stress, plasticity and the max-velocity clamp; the MDL_DATA tables' curve
    evaluations (`mdl_lookups`, each walking `n_pts` points) every step; a
    robot's share of the clamp and of equilibrium mode's ring every step; BC
    regions add none (module docstring). Bytes: the material channels of
    the body, the MDL_DATA tables and the BC channels read, the strain
    offset's three state channels read and written."""
    occupied, steps, _ = _feature_counts(body, stats, stats_out)
    per_voxel, per_step = 0.0, 0.0
    if flags.get("nonlinear"):
        per_voxel += NONLINEAR_FLOPS_PER_VOXEL
    if flags.get("mdl_data") and n_pts:
        per_step = per_step + mdl_lookups(body, grid_shape).to(steps.dtype) * (
            MDL_FLOPS_PER_LOOKUP + MDL_FLOPS_PER_POINT * (n_pts - 2))
    if flags.get("plasticity"):
        per_voxel += PLASTIC_FLOPS_PER_VOXEL
    if flags.get("equilibrium"):
        per_step += EQUILIBRIUM_FLOPS_PER_STEP
    elif flags.get("max_vel"):  # the mode turns the clamp off
        per_voxel += MAX_VEL_FLOPS_PER_VOXEL
        per_step += MAX_VEL_FLOPS_PER_STEP
    flops = float(((occupied * per_voxel + per_step) * steps).sum())
    V, Bb, B = body.shape[-1], body.shape[0], stats.shape[0]
    channels = MATERIAL_BODY_CHANNELS if flags.get("nonlinear") else 0
    channels += (2 * n_pts + 3) if flags.get("mdl_data") else 0
    channels += BC_CHANNELS if flags.get("bc") else 0
    nbytes = 4.0 * Bb * channels * V
    if flags.get("plasticity"):
        nbytes += 4.0 * 2 * 3 * B * V
    return flops, nbytes


def volume_clock(stats, stats_out, num_steps):
    """`stats` with each robot's dt replaced by the mean dt of a volume
    launch of `num_steps` steps, so that `steps_taken` counts its steps: a
    robot that ends live (not diverged, short of its stop time) took them
    all; one that froze, as many as its time span holds at the larger of its
    first and last dt (a lower count)."""
    t_in, t_out = stats[:, fr._S_TIME], stats_out[:, fr._S_TIME]
    live = (stats_out[:, fr._S_DIV] < 0.5) & (t_out < stats_out[:, fr._S_STOP])
    dt_max = torch.maximum(stats[:, fr._S_DT], stats_out[:, fr._S_DT])
    steps = torch.where(live, torch.full_like(t_in, float(num_steps)),
                        torch.floor((t_out - t_in) / dt_max))
    out = stats.clone()
    out[:, fr._S_DT] = torch.where(steps > 0, (t_out - t_in) / steps, stats[:, fr._S_DT])
    return out


def b6d_work(state, body, stats, stats_out, flags):
    """(flops, bytes) volume effects add to one K1 launch (module
    docstring): `VOLUME_FLOPS_PER_VOXEL` for every occupied voxel and
    `VOLUME_FLOPS_PER_STEP` for every robot on every step (the stats under
    `volume_clock`); bytes, the body's volume channels read (Young's modulus
    counted once, with the nonlinear stress's) and the state's coupling
    carry read and written."""
    occupied, steps, _ = _feature_counts(body, stats, stats_out)
    flops = float(((occupied * VOLUME_FLOPS_PER_VOXEL + VOLUME_FLOPS_PER_STEP) * steps).sum())
    B, V = state.shape[0], state.shape[-1]
    channels = VOLUME_BODY_CHANNELS - (1 if flags.get("nonlinear") else 0)
    return flops, 4.0 * (body.shape[0] * channels * V + 2 * VOLUME_STATE_CHANNELS * B * V)


def launch_work(state, body, stats, table, stats_out, controls=None, *,
                flags, grid_shape, scalars=None, n_pts=0, num_steps=None):
    """(flops, bytes) of one K1 launch, the sum of its variant's count and
    its options' counts: the step of the variant its flags select,
    `b7_work` in a fluid, `b8_work` with development fields, else `k1_work`
    (with the compact contact pass `b5_work` in place of the dense one, in
    any variant); and the fitness features' and the material instance's
    work on top (`b8b_work`, `b8c_work`, `b8d_work` with the sources of
    `scalars`; `b6_work` with `n_pts` MDL_DATA points; `b6d_work` under
    volume effects, whose launches need their `num_steps`: `volume_clock`).
    The options' counts are the same in every variant: the kernels run the
    same walk of them (csrc/k1_step.cuh), and the facet drag's corners read
    the per-side strains the stress equalization leaves anyway."""
    if flags.get("volume"):
        if num_steps is None:
            raise ValueError("a volume-effects launch is counted from its num_steps")
        stats = volume_clock(stats, stats_out, num_steps)
    compact = bool(flags.get("collision_compact"))
    dense = None if compact else table
    if flags.get("fluid"):
        work = b7_work(state, body, stats, dense, stats_out, grid_shape,
                       mesh=bool(flags.get("fluid_mesh")))
    elif any(flags.get(k) for k in fr._K1_DEVO_FLAGS):
        work = b8_work(state, body, stats, dense, stats_out)
    else:
        work = k1_work(state, body, stats, dense, stats_out, controls)
    parts = [work]
    if compact:
        parts.append(b5_work(table, stats, stats_out))
    if any(flags.get(k) for k in fr._K1_FEATURE_FLAGS):
        parts.append(b8c_work(body, stats, stats_out, flags))
    if flags.get("ballistic"):
        parts.append(b8b_work(body, stats, stats_out))
    n_src = len((scalars or {}).get("sources", ()))
    if n_src:
        parts.append(b8d_work(body, stats, stats_out, n_src))
    if any(flags.get(k) for k in fr._K1_MAT_FLAGS if k not in ("collision_compact", "volume")):
        parts.append(b6_work(body, stats, stats_out, flags, grid_shape, n_pts))
    if flags.get("volume"):
        parts.append(b6d_work(state, body, stats, stats_out, flags))
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def _feature_counts(body, stats, stats_out):
    """(occupied voxels (B or 1,), steps (B,), steps past InitCmTime (B,))
    of a launch."""
    steps = steps_taken(stats, stats_out)
    occupied = (body[:, fr._B_OCC, :] > 0.5).sum(1).to(steps.dtype)
    dt = stats[:, fr._S_DT]
    before = torch.clamp(torch.ceil((stats[:, fr._S_INITCM] - stats[:, fr._S_TIME]) / dt),
                         min=0.0)
    return occupied, steps, torch.clamp(steps - before, min=0.0)


def b8c_work(body, stats, stats_out, flags):
    """(flops, bytes) the trace, needle, fall-over and end-of-life
    bookkeeping add to one K1 launch: a trace sample for every sample each
    robot took (its trace count's rise), the latch's counts on every step
    past its InitCmTime, the end-of-life and needle reductions for each
    capture. Bytes: the feature channels of the stats rows in and out."""
    occupied, steps, after = _feature_counts(body, stats, stats_out)
    samples = stats_out[:, fr._S_NTR] - stats[:, fr._S_NTR]
    per = samples * TRACE_SAMPLE_FLOPS_PER_VOXEL
    if flags.get("falling"):
        per = per + after * FALL_LATCH_FLOPS_PER_VOXEL
    if any(flags.get(k) for k in fr._K1_FEATURE_FLAGS):
        per = per + (stats_out[:, fr._S_EOLCAP] - stats[:, fr._S_EOLCAP]) \
            * EOL_POSTERIOR_FLOPS_PER_VOXEL
    if flags.get("needle"):
        captures = (stats_out[:, fr._S_NCAP] - stats[:, fr._S_NCAP]) + (steps > 0).to(steps.dtype)
        per = per + captures * NEEDLE_FLOPS_PER_VOXEL
    n_feat = fr._S_EOLCAP + 1 - fr._S_FELL
    return float((occupied * per).sum()), 4.0 * 2 * stats.shape[0] * n_feat


def b8d_work(body, stats, stats_out, n_src):
    """(flops, bytes) of tracking `n_src` sources in one K1 launch: every
    occupied voxel's distance to each source on every step; bytes, the
    sources' stats channels in and out."""
    occupied, steps, _ = _feature_counts(body, stats, stats_out)
    flops = float((occupied * steps).sum()) * SOURCE_FLOPS_PER_VOXEL * n_src
    return flops, 4.0 * 2 * stats.shape[0] * (2 * n_src + 1)


def b8b_work(body, stats, stats_out):
    """(flops, bytes) of the ballistic rebase in one K1 launch: every
    occupied voxel on every step, and its four development channels read
    and written."""
    occupied, steps, _ = _feature_counts(body, stats, stats_out)
    return (float((occupied * steps).sum()) * BALLISTIC_FLOPS_PER_VOXEL,
            4.0 * 2 * 4 * stats.shape[0] * body.shape[-1])


def b4_work(state, body, stats, controls, steps, flags=None, grid_shape=None):
    """(flops, bytes) that one B4 launch on these packed tensors needs.

    `steps` (B,) are the steps each robot's segment really took (a frozen
    robot's skipped steps are the identity). Operations: for every occupied
    voxel and step the forward recompute and the adjoint of the step, in
    the variant the launch's `flags` select: on land `STEP_FLOPS_PER_VOXEL`
    and `ADJOINT_FLOPS_PER_VOXEL`; in water with the voxel-face drag, or
    with development fields, their own two counts; with the facet drag the
    forward and adjoint counts a voxel and, for every step, the robot's
    surface mesh's triangles, vertices and corners (`mesh_counts` on
    `grid_shape`); with `nonlinear` or `max_vel` (the material instance of
    any variant) the forward and adjoint counts of each option on top, and
    the clamp's share a robot. Bytes: what the function must move, whatever the
    kernel keeps in its tape or its scratch: the start state's carried
    channels and the end state's cotangent in, the start state's cotangent
    out, the body channels the step reads (with development the six fields
    more, with nonlinear materials the four material channels), the stats
    rows, the controls in and their cotangent out."""
    flags = flags or {}
    B, _, V = state.shape
    steps = torch.as_tensor(steps, dtype=torch.float32, device=state.device)
    occupied = (body[:, fr._B_OCC, :] > 0.5).sum(1).to(steps.dtype)  # (B or 1,)
    per_voxel = STEP_FLOPS_PER_VOXEL + ADJOINT_FLOPS_PER_VOXEL
    per_step = torch.zeros_like(occupied)
    body_channels = K1_BODY_CHANNELS
    if fr.facet_drag(flags):
        per_voxel = FLUID_MESH_STEP_FLOPS_PER_VOXEL + FLUID_MESH_ADJOINT_FLOPS_PER_VOXEL
        X, Y, Z = grid_shape
        tris, verts, corners = (c.to(steps.dtype) for c in mesh_counts(
            body[:, fr._B_OCC, :].reshape(-1, X, Y, Z) > 0.5))
        per_step = ((MESH_FLOPS_PER_TRIANGLE + MESH_ADJOINT_FLOPS_PER_TRIANGLE) * tris
                    + (MESH_FLOPS_PER_VERTEX + MESH_ADJOINT_FLOPS_PER_VERTEX) * verts
                    + (MESH_FLOPS_PER_CORNER + MESH_ADJOINT_FLOPS_PER_CORNER) * corners)
    elif flags.get("fluid"):
        per_voxel = FLUID_FACE_STEP_FLOPS_PER_VOXEL + FLUID_FACE_ADJOINT_FLOPS_PER_VOXEL
    elif any(flags.get(k) for k in fr._K1_DEVO_FLAGS):
        per_voxel = DEVO_STEP_FLOPS_PER_VOXEL + DEVO_ADJOINT_FLOPS_PER_VOXEL
        body_channels += K1_DEVO_BODY_CHANNELS
    # the material instance's options, on top of any variant's step
    if flags.get("nonlinear"):
        per_voxel += NONLINEAR_FLOPS_PER_VOXEL + NONLINEAR_ADJOINT_FLOPS_PER_VOXEL
        body_channels += MATERIAL_BODY_CHANNELS
    if flags.get("max_vel"):
        per_voxel += MAX_VEL_FLOPS_PER_VOXEL + MAX_VEL_ADJOINT_FLOPS_PER_VOXEL
        per_step = per_step + MAX_VEL_FLOPS_PER_STEP
    flops = float(((occupied * per_voxel + per_step) * steps).sum())
    nbytes = 4.0 * (3 * B * K1_STATE_CHANNELS * V
                    + body.shape[0] * body_channels * V
                    + stats.numel() + 2 * controls.numel())
    return flops, nbytes


def b5_pass_work(pos, scale, table):
    """(flops, bytes) that one launch of the compact pass's own kernel
    (`pair_contact_forces_compact`) on these inputs needs, counted as
    `k2_work` over the surface voxels: the tested pairs (nonzero entries of
    the (S, S) table, for every robot) and the touching ones; bytes, the
    positions and scales read, the table, the forces written."""
    idx = table[:, 0].long().expand(pos.shape[0], -1)
    ps = torch.gather(pos, 2, idx[:, None, :].expand(-1, 3, -1))
    flops, _ = k2_work(ps, torch.gather(scale, 1, idx), table[:, 1:])
    return flops, 4.0 * (pos.numel() + scale.numel() + table.numel() + pos.numel())


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
