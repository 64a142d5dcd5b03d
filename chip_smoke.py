#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`evosoro_tpu_torch`) on one card.

Builds the hand-written CUDA kernels from `evosoro_tpu_torch/ops/csrc`,
holds each kernel against its plain PyTorch version, and drives the port's
main paths: two generations each of the evolution experiments of
examples/basic.py, swimming_basic.py and growth.py (evaluation through the
fused rollout kernel K1 with its in-kernel contact pass K2, in water with
the facet drag on the deformed surface mesh, and with the development
ramps) and of their feature twins (basic with NormDistByVol, the fall-over
latch, speed windows and a light source; growth with ballistic
development, both through K1's feature instance), the sampling-MPC
benchmark of tools/bench_mpc.py (a cold CEM
solve and a closed receding-horizon loop through K1's control-knot channel),
and its gradient-MPC part (FusedSQPSolver: K1 segments forward, the
reverse-mode segment kernel B4 backward) on land, in water with the facet
and with the voxel-face drag, with growth, and on a bilinear palette with
the max-velocity clamp (on land, in water and with growth), and two
generations of the swimming twin of the materials experiment.
It measures the card's FP32 rate with the fma_peak micro-kernel, sets each
kernel's time beside the least time the card could take, and measures the
bench.py throughput workload. Every phase prints one JSON line; any failure
raises and exits non-zero. The last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.

Run from the repository root:  python3 chip_smoke.py

Every comparison of K1 (land variant, knots, segments) and of B4 also prints
the SHA-256 of the kernel's output. `python3 chip_smoke.py --land` runs only
those phases and a timing of the land path's three launches, and ends with
one JSON object of the digests and times: copied into a checkout of another
commit (the mode uses only names the port has had since B4 came) and run
there in the same call, it tells whether the two commits compute the same
bits on the land path, and lets their times be read in turns.

`python3 chip_smoke.py --diff` runs gradient MPC alone: B4 against its
plain version on land (`phase_b4`) and in each of its fluid and development
instances with their guards, beside the K1 launches of the same solves
(`phase_b4_variants`) and in its material instance on the bilinear palette
with the max-velocity clamp (`phase_b4_materials`), then `bench.sqp` on
land, in each variant and on materials (`phase_sqp`, `phase_sqp_variants`,
`phase_sqp_materials`); its kernels line holds B4's rows, each with its
launch shape (blocks a robot, threads, shared-memory or device-memory
instance). `python3 chip_smoke.py --diff --against CHECKOUT` times B4 in
turns with another checkout's (`phase_b4_against`): the SQP launch of each
instance, one re-plan of each `bench.sqp` variant, and the split of the
land launch between its recompute and its reverse sweep, each arm's bits
held equal.

`python3 chip_smoke.py --features` runs K1's fitness features alone: the
comparisons and guards of `phase_k1_features`, the cost of the bookkeeping
on 1024 x 10^3 x 200 steps, and two generations each of the two feature
experiments.

`python3 chip_smoke.py --materials` runs Voxelyze's material, solver and
boundary options and the surface-compacted contact pass alone: the replay
path of the four fixture .vxa files and the cantilever (`phase_replay`),
the comparisons and guards of `phase_k1_materials` with the costs of B5 and
B6 on 1024 x 10^3, and two generations of the materials experiment.

`python3 chip_smoke.py --big` runs bodies past one block's shared memory
alone (`phase_big`, also part of the full run): K1's and B4's
device-memory instances bit for bit against their shared-memory twins,
against the plain versions at 12^3, 13^3 and 16^3 and on a 12^3 swimmer in
its 13^3 shell, the guard of one buffer for every robot, their times, and
the main paths at 12^3 (two generations of the basic experiment with
contact, a cantilever's replay, a cold CEM solve, the fused SQP solve); its
kernels line holds the two device-memory rows.

`python3 chip_smoke.py --compact` runs the surface-compacted contact pass
(B5) alone (`phase_compact`, `phase_compact_times`): K1's compact launch
against its plain version in the kernels' order and bit for bit against
the dense launch on the bench design (both in the material instance),
each fixture and the 12^3 twins, the pass's own launch against the dense
plain pass and the census's tiles, the cull's guard, the replay path with
the compact switch, then the compact and dense launches' times and the
compact instances' registers. `python3 chip_smoke.py --compact --against
CHECKOUT [CHECKOUT ...]` times them in turns with other checkouts' K1,
this tree's bits held equal across its turns, and holds the dense kernels
whose machine code moved by design to the other trees' bits.

`python3 chip_smoke.py --pair` runs the dense pair pass (B2) alone: K2
against its plain version (`phase_k2`), then `phase_pair` (also part of the
full run): two launches bit-equal to each other, the cull's guard, the
tiles evaluated of all tiles at 6^3, 10^3 and 12^3, the contact workloads'
times, and two generations of the basic experiment at 6^3 and at 12^3.

`python3 chip_smoke.py --step` runs K1's own step (B1) and its knot launch
(B3) alone (`phase_step`, also part of the full run): K1 against its plain
version on a cut batch of each instance, the one-robot 6^3 step with and
without contact, 16 x 6^3 x 25, 1024 x 10^3 x 200 in the land, material,
volume and both drag instances, the cold solve's 128 x 10^3 x 200 launch
with 8 knots and the SQP segment, each with its block size and whether
its state stayed resident; then two basic generations and a cold CEM
solve with the counters zeroed; its kernels line holds B1's and B3's rows.
`python3 chip_smoke.py --step --against CHECKOUT` times each of these in
turns with another checkout's K1 (its parent's, unpacked into a directory
that .gitignore lists), and with the state kept in device memory where it
would stay resident.

`python3 chip_smoke.py --mat-variants` runs K1's and B4's material,
compact-contact and volume instances in water and with growth alone
(`phase_k1_mat_variants`, `phase_b4_mat_variants`, also part of the full
run): each K1 instance (voxel-face drag, facet drag, growth; with and
without volume effects and the features; without contact, dense and
compact; shared and device-memory) against its plain version, the twins
and the compact launch bit-equal to the shared and dense ones, each with
its guards; B4's material instance of each variant against autograd with
its recompute bit-equal to K1's launch; then the times of the 1024-robot
workloads (`phase_mat_variants_times`), `bench.sqp(materials=True)` in each
variant and two generations of the swimming-materials experiment, with the
counters zeroed before and read after.

`python3 chip_smoke.py --eager` runs the eager-step evaluator alone
(`phase_eager`, also part of the full run): the eager rollout on the card
against itself on the CPU under the limited floor with contact, 4 sources
and windows of 13 trace steps, with the whole floor as its guard; the
eager step's time; two generations of the `limited_floor` experiment (the
eager route, no kernel launched); a basic generation that must take K1;
and the kernel-vs-eager selection agreement at a cut size.

`python3 chip_smoke.py --parallel` runs the multi-device paths alone on the
one card, a device list naming it more than once (`phase_parallel`, also
part of the full run at `PARALLEL_CUT`): K1 sharded over four entries bit
for bit against one launch, a generation over two entries bit for bit
against one device, a sharded fused CEM solve and SQP multistart against
the unsharded ones, a spatial rollout over four slabs in float64 against
the one-slab eager rollout, and two processes on the card through
torch.distributed with the gloo backend (NCCL refuses two ranks on one
GPU), each rank's generation and two-slab rollout against one process.

`python3 chip_smoke.py --tools` runs the off-path tools alone
(`phase_tools`, also part of the full run with its parity scenarios cut to
25 steps): `record_trajectory` of examples/visualize.py's robot through K1,
a launch a frame, bit for bit against one launch at three frame boundaries
and against the eager route over its first 100 steps; the renderer's
surface on the card against the CPU and the deformed mesh through
`io.mesh_io`; `fea_solve` and `tensile_test` in float64 against the
analytic beams; the sandbox's scripted REPL and a poke; and the 12 K1
parity scenarios of `evosoro_tpu_torch.onchip_parity`, whose record the
phase's line holds (`record`) and which is held to the committed
ONCHIP_PARITY_TORCH.json.

`python3 chip_smoke.py --volume` runs volume effects alone
(`phase_k1_volume`): K1's volume instance against its plain version with
its three guards, the volume replay of an archived design and of the
cantilever, two generations of the volume experiment, a cold CEM solve
with volume effects and the volume throughput in turns with the land and
material instances.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# tolerances of tests/test_fused_rollout.py:63-78 (fused kernel vs eager step)
TOL = dict(pos=(2e-5, 1e-9), quat=(2e-5, 1e-7), linmom=(1e-4, 1e-10),
           scale=(1e-6, 0.0), time=(1e-6, 0.0))
# the facet drag against its gather/scatter plain version: the tolerances of
# tests/test_fused_rollout.py:766-774 between the JAX package's kernel and
# its jnp step (the 12 facet terms and the 8 corners of a vertex are summed
# in another order, and index_add_ on the card sums with atomics), with the
# land step's quat group and its rtol for linmom: at 200 x the experiment's
# drag the two part by 9.3e-6 in momenta up to 0.37 (H100, first runs of
# this script with the facet drag), five times under the atol
MESH_TOL = dict(pos=(2e-5, 1e-8), quat=(2e-5, 1e-7), linmom=(1e-4, 5e-5),
                scale=(1e-6, 0.0), time=(1e-6, 0.0))
# what a guard must show: the effect it looks for (another drag model, no
# drag) is at least this many times the kernel's own error
GUARD_RATIO = 20.0
# the drag coefficient at which drag weighs as much as elasticity, so that
# a wrong drag fails the stated tolerances outright (200 x the experiment's)
STRONG_DRAG = 1.5e5
# K2: the pair sums run in another order than torch.sum
K2_REL_TOL = 1e-4
# 100-step drift band of ONCHIP_PARITY.json for chaotic dynamic scenarios
# (tests/test_onchip_parity_artifact.py CHAOTIC_BOUND)
DRIFT_BOUND_M = 5e-5
# fma_peak against its plain version, which rounds once a step as a fused
# multiply-add does: 4 float32 ulps on the sum, at a chain length that moves
# the result by a thousand times that, and most sums equal bit for bit
FMA_CHECK_ITERS = 4096
FMA_RTOL = 2.0 ** -21
FMA_EQUAL_SHARE = 0.999
# a reading above the published FP32 rate by more than this is a wrong count
PEAK_SLACK = 1.05
# volume effects against their plain version: the tolerances of
# tests/test_fused_rollout.py:284-327 (the JAX kernel against its jnp step):
# positions, scales, the coupling carry's side means (transverse sums,
# cross-sections), and the dt and time of the stats row
VOL_TOL = dict(pos=(2e-4, 2e-8), scale=(1e-5, 0.0), time=(1e-6, 0.0))
VOL_TS = (2e-3, 1e-6)
VOL_CS = (1e-4, 0.0)
VOL_DT_RTOL = 1e-6
# B4 against autograd through the plain version: every channel group's
# largest error over that group's largest plain value. The two sum the same
# float32 terms in different orders over 25 steps; tests/test_fused_diff.py
# allows the TPU kernel 5e-3 against BPTT
B4_REL_TOL = 2e-3


T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:  # seconds since the start, to read where the run's time goes
        obj = dict(obj, elapsed_s=round(time.perf_counter() - T0, 1))
    print(json.dumps(obj), flush=True)


# case -> SHA-256 (first 16 hex digits) of a kernel's output tensors, for
# holding two commits against each other (`--land`)
DIGESTS = {}


def _digest(key, *tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    assert key not in DIGESTS, key
    DIGESTS[key] = h.hexdigest()[:16]
    return DIGESTS[key]


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run "
                         "only on the card")
    from evosoro_tpu_torch.bench import card_info

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = card_info()
    emit(dict(phase="device", nvidia_smi=info,
              torch=torch.__version__, cuda=torch.version.cuda,
              count=torch.cuda.device_count(),
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              cudnn_allow_tf32=torch.backends.cudnn.allow_tf32))
    return info


def phase_build():
    from evosoro_tpu_torch.ops import build

    secs = build.build_all()
    # each kernel's name (a variant of the step is a template instance, the
    # number after `ILi` in its mangled name), registers and spills
    ptxas = {name: [ln.strip().replace("ptxas info    : ", "")
                    for ln in build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name in build.SIGNATURES}
    # fused multiply-adds in fma_peak's machine code, which names the
    # instruction (counting them in the rollout libraries, 150 kernels, took
    # 90 s of the full run's limit)
    ffma = {"fma_peak": build.sass_count("fma_peak", "FFMA")}
    emit(dict(phase="build", seconds=secs, ptxas=ptxas, sass_ffma=ffma))
    assert ffma["fma_peak"] >= 16, ffma


def _event_ms(torch, fn, reps, warm=True):
    """Milliseconds a call of `fn` takes on the card, over `reps` calls after
    one warm-up call; a plain version, which has nothing to warm, is timed
    without it (`warm=False`)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _timed_once(torch, out, timed, fn):
    """fn(), its milliseconds on the card appended to `out` when `timed`
    (CUDA events around the one call, as `_event_ms(..., 1, warm=False)`)."""
    if not timed:
        return fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    res = fn()
    b.record()
    torch.cuda.synchronize()
    out.append(a.elapsed_time(b))
    return res


def _contact_positions(torch, np, pos, shrink, seed=0):
    """Shrink each robot's lattice about its centre and jitter it, so
    surface voxels far apart in the lattice come into contact."""
    rng = np.random.default_rng(seed)
    nom = pos.cpu().numpy()
    centre = nom.mean(-1, keepdims=True)
    out = centre + shrink * (nom - centre) + rng.normal(0, 5e-4, size=nom.shape)
    return torch.as_tensor(out, dtype=torch.float32, device="cuda").contiguous()


def _k2_case(torch, fr, label, pos, scale, a1):
    before = fr.PAIR_CONTACT_LAUNCHES
    f_k = fr.pair_contact_forces(pos, scale, a1)
    torch.cuda.synchronize()
    assert fr.PAIR_CONTACT_LAUNCHES == before + 1
    f_p = fr.pair_contact_forces_plain(pos, scale, a1)
    fmax = float(f_p.abs().max())
    assert fmax > 0, f"no contacts in the K2 workload {label}"
    err = float((f_k - f_p).abs().max())
    rel = err / fmax
    ms = _event_ms(torch, lambda: fr.pair_contact_forces(pos, scale, a1), 20)
    plain_ms = _event_ms(torch, lambda: fr.pair_contact_forces_plain(pos, scale, a1), 5)
    from evosoro_tpu_torch import roofline

    rec = dict(phase="k2_vs_plain", workload=label, shape=list(pos.shape),
               table_shape=list(a1.shape), max_abs_err=err, max_abs_force=fmax,
               rel_err=rel, tol=K2_REL_TOL,
               active_voxels=int(((f_p.abs().sum(1)) > 0).sum()),
               ms=ms, plain_ms=plain_ms,
               **roofline.bound(*roofline.k2_work(pos, scale, a1)))
    emit(rec)
    assert rel <= K2_REL_TOL, rec
    return rec


def phase_k2(torch, np):
    """K2 on the bench.py 10^3 design (8 robots, one shared table) and on the
    evaluator's own batch (16 robots x 6^3, a table per robot)."""
    from evosoro_tpu_torch.bench import bench_body, evaluator_workload
    from evosoro_tpu_torch.core.collision import build_collision_system
    from evosoro_tpu_torch.ops import fused_rollout as fr

    n, B = 10, 8
    structure, body = bench_body(n, device="cuda")
    cs = build_collision_system(structure, body.e_mod.cpu().numpy(), 0.01)
    a1 = torch.as_tensor(fr.pack_collision(cs, (n, n, n)), device="cuda")
    a1 = a1[None].expand(B, -1, -1).contiguous()
    nom = body.nom_pos.reshape(-1, 3).T[None].expand(B, -1, -1)
    _k2_case(torch, fr, "bench 10^3, one design's table for every robot",
             _contact_positions(torch, np, nom, 0.5),
             torch.full((B, n ** 3), 0.01, device="cuda"), a1)

    (state, _, _, table), _ = evaluator_workload(collision=True, device="cuda")
    return _k2_case(torch, fr, "evaluator batch 6^3, table per robot",
                    _contact_positions(torch, np, state[:, fr._POS:fr._POS + 3], 0.4),
                    state[:, fr._SCALE].contiguous(), table)


def _pair_guard_inputs(torch, np, fr, compact=False):
    """A 10^3 grid with material in x = 0-3 and x = 7-9 only, the second
    part pushed to 1.3 cells from the first: its only touching pairs lie
    across the gap, in tiles whose boxes are 1.3 cells apart. (pos, scale,
    table) of one robot on the card; `compact`: the compact table."""
    from evosoro_tpu_torch.core import build_body, evosoro_default_palette, palette_from_list
    from evosoro_tpu_torch.core.collision import build_collision_system

    rng = np.random.default_rng(3)
    n = 10
    structure = np.zeros((n, n, n), dtype=np.int32)
    structure[:4] = rng.integers(1, 5, size=(4, n, n))
    structure[7:] = rng.integers(1, 5, size=(3, n, n))
    body = build_body(structure, palette_from_list(evosoro_default_palette()))
    pack = fr.pack_collision_compact if compact else fr.pack_collision
    table = pack(build_collision_system(structure, body.e_mod.numpy(), 0.01), structure.shape)
    pos = body.nom_pos.reshape(-1, 3).T.numpy().copy()
    pos[0, np.arange(n ** 3) // n ** 2 >= 7] -= 0.027
    pos = pos + rng.normal(0, 2e-4, pos.shape)
    cuda = dict(dtype=torch.float32, device="cuda")
    return (torch.as_tensor(pos[None], **cuda).contiguous(),
            torch.full((1, n ** 3), 0.01, **cuda), torch.as_tensor(table[None], **cuda))


def _tile_census(torch, fr, label, pos, scale, table):
    """K2's tile counts on these inputs against the plain census."""
    counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    fr.pair_contact_forces(pos, scale, table, counts=counts)
    got = tuple(int(c) for c in counts.cpu())
    want = fr.pair_tile_census_plain(pos.cpu(), scale.cpu(), table.cpu())
    B, _, V = pos.shape
    rec = dict(phase="pair_tiles", workload=label, batch=B, voxels=V,
               groups=fr.pair_groups(V), tiles_total=sum(got), tiles_evaluated=got[0],
               tiles_culled_by_distance=got[1], tiles_culled_statically=got[2],
               evaluated_share=got[0] / sum(got), plain_census=list(want),
               nonzero_entries=int((table != 0).sum()) * (B if table.shape[0] == 1 else 1),
               equal=got == want)
    emit(rec)
    assert rec["equal"] and sum(got) == B * fr.pair_groups(V) ** 2, rec
    return rec


def phase_pair(torch, np, alone=False):
    """The dense pair pass (B2, csrc/pair_contact.cuh) beyond its K2 and K1
    comparisons: two launches bit-equal to each other (K1 on the evaluator
    batch in shared memory and on the 12^3 batch in its device-memory twin,
    K2), the cull's guard (a margin of -0.5 drops the touching pairs of
    `_pair_guard_inputs`), the tiles evaluated of all tiles at 6^3, 10^3 and
    12^3 after 100 steps (K2's counts against the plain census), and the
    times of the contact workloads: one 6^3 robot a step with and without
    contact, the evaluator batch 16 x 6^3 x 25, 1024 x 10^3 x 20, 32 x 12^3
    and 32 x 13^3 x 100 steps, each beside its bound; `alone` (`--pair`)
    adds two generations of the basic experiment at 6^3 and at 12^3 (0.5 s
    of sim), which the full run times in `phase_evolution` and `phase_big`."""
    import math
    from unittest import mock

    from evosoro_tpu_torch import bench, roofline
    from evosoro_tpu_torch.ops import fused_rollout as fr

    res = {}
    # two launches, the same bits
    args, kw = bench.evaluator_workload(collision=True, device="cuda")
    big, big_kw, _ = bench.big_body_workload(8, n=12, device="cuda")
    pos = _contact_positions(torch, np, args[0][:, fr._POS:fr._POS + 3], 0.4)
    scale = args[0][:, fr._SCALE].contiguous()
    runs = {"K1 evaluator batch 16 x 6^3, 25 steps": lambda: fr.fused_call(
                *args, num_steps=25, **kw),
            "K1 device-memory twin 8 x 12^3, 25 steps": lambda: fr.fused_call(
                *big, num_steps=25, **big_kw),
            "K2 evaluator batch 16 x 6^3 shrunk into contact": lambda: (
                fr.pair_contact_forces(pos, scale, args[3]),)}
    equal = {}
    for label, run in runs.items():
        a, b = run(), run()
        equal[label] = all(torch.equal(x, y) for x, y in zip(a, b))
    res["bit_equal"] = dict(phase="pair_bit_equal", runs=equal)
    emit(res["bit_equal"])
    assert all(equal.values()), equal

    # the guard: a negative margin drops the pairs across the gap
    gpos, gscale, gtab = _pair_guard_inputs(torch, np, fr)
    ref = fr.pair_contact_forces_plain(gpos, gscale, gtab)
    fmax = float(ref.abs().max())
    err = float((fr.pair_contact_forces(gpos, gscale, gtab) - ref).abs().max())
    with mock.patch.object(fr, "PAIR_CULL_MARGIN", -0.5):
        bad = float((fr.pair_contact_forces(gpos, gscale, gtab) - ref).abs().max())
    res["guard"] = dict(phase="pair_guard", max_abs_force=fmax, rel_err=err / fmax,
                        rel_err_margin_minus_half=bad / fmax, tol=K2_REL_TOL,
                        guard_ratio=bad / fmax / K2_REL_TOL)
    emit(res["guard"])
    assert fmax > 0 and err / fmax <= K2_REL_TOL, res["guard"]
    assert bad / fmax >= GUARD_RATIO * K2_REL_TOL, res["guard"]

    # tiles evaluated, from states 100 steps in
    tiles = []
    bench_args, bench_kw, _ = bench.packed_workload(8, collision=True, device="cuda")
    for label, (a, k) in (("evaluator batch 16 x 6^3", (args, kw)),
                          ("bench 8 x 10^3, shared table", (bench_args, bench_kw)),
                          ("big-body batch 8 x 12^3", (big, big_kw))):
        st, _ = fr.fused_call(*a, num_steps=100, **k)
        tiles.append(_tile_census(torch, fr, label + ", 100 steps in",
                                  st[:, fr._POS:fr._POS + 3].contiguous(),
                                  st[:, fr._SCALE].contiguous(), a[3]))
    res["tiles"] = tiles

    # times, each beside its bound
    def timed(label, a, k, steps, groups=3, reps=2, per_step=False):
        ms = bench.time_call(lambda: fr.fused_call(*a, num_steps=steps, **k), groups, reps)
        _, st_out = fr.fused_call(*a, num_steps=steps, **k)
        rec = dict(phase="pair_time", workload=label, steps=steps, ms=ms,
                   contact=a[3] is not None,
                   **roofline.bound(*roofline.launch_work(
                       *a, st_out, flags=k["flags"], grid_shape=k["grid_shape"])))
        if per_step:
            rec["us_a_step"] = 1e3 * ms / steps
        emit(rec)
        return rec

    times = []
    one = tuple(t[:1].contiguous() if t is not None else None for t in args)
    args_nc, kw_nc = bench.evaluator_workload(collision=False, device="cuda")
    one_nc = tuple(t[:1].contiguous() if t is not None else None for t in args_nc)
    times.append(timed("one robot of the evaluator batch, 6^3, contact on", one, kw, 2000,
                       per_step=True))
    times.append(timed("one robot of the evaluator batch, 6^3, contact off", one_nc, kw_nc,
                       2000, per_step=True))
    times.append(timed("evaluator batch 16 x 6^3, contact on", args, kw, 25))
    coll = bench.throughput(batch=1024, steps=20, collision=True, groups=3, reps=2)
    emit(dict(phase="pair_time", workload="bench 1024 x 10^3, contact on", **coll))
    times.append(coll)
    for n in (12, 13):
        a, k, _ = bench.big_body_workload(32, n=n, device="cuda")
        times.append(timed("big-body batch 32 x %d^3, contact on" % n, a, k, 100, 2, 1))
    res["times"] = times
    res["contact_launches"] = res["k2_launches"] = None
    if alone:
        from evosoro_tpu_torch.bench import evolution

        fr.FUSED_ROLLOUT_CONTACT_LAUNCHES = 0
        fr.PAIR_CONTACT_LAUNCHES = 0
        for label, settings in (("basic 6^3", {}),
                                ("basic 12^3, 0.5 s of sim",
                                 dict(size=(12, 12, 12), sim_time=BIG_SIM_TIME,
                                      init_time=BIG_INIT_TIME))):
            before = fr.FUSED_ROLLOUT_CONTACT_LAUNCHES
            for r in evolution(gens=2, pop_size=15, device="cuda", experiment="basic",
                               **settings):
                fits = r.pop("fitnesses")
                r.update(phase="pair_evolution", experiment=label,
                         all_finite=all(math.isfinite(f) for f in fits))
                emit(r)
                assert r["all_finite"] and r["k1_launches"] > 0, r
            assert fr.FUSED_ROLLOUT_CONTACT_LAUNCHES > before
        res["contact_launches"] = fr.FUSED_ROLLOUT_CONTACT_LAUNCHES
        res["k2_launches"] = fr.PAIR_CONTACT_LAUNCHES
    return res


def _compare(torch, fr, out_k, st_k, out_p, st_p, tol=TOL, need_small=True):
    def ch(x, a, b):
        return x[:, a:b, :]

    errs, ok = {}, True
    for name, (a, b) in dict(pos=(fr._POS, fr._POS + 3),
                             quat=(fr._QUAT, fr._QUAT + 4),
                             linmom=(fr._LIN, fr._LIN + 3),
                             scale=(fr._SCALE, fr._SCALE + 1)).items():
        k, p = ch(out_k, a, b), ch(out_p, a, b)
        d = (k - p).abs()
        errs[name] = float(d.max())
        if name in tol:  # a group the tolerance does not name is reported only
            rtol, atol = tol[name]
            ok &= bool((d <= atol + rtol * p.abs()).all())
    tk, tp = st_k[:, fr._S_TIME], st_p[:, fr._S_TIME]
    errs["time"] = float((tk - tp).abs().max())
    ok &= bool(((tk - tp).abs() <= tol["time"][0] * tp.abs()).all())
    same_small = bool(torch.equal(ch(out_k, fr._SMALL, fr._SMALL + 3),
                                  ch(out_p, fr._SMALL, fr._SMALL + 3)))
    errs["small_angle_equal"] = same_small
    errs["ini_cm"] = float((st_k[:, fr._S_INICM:fr._S_INICM + 3]
                            - st_p[:, fr._S_INICM:fr._S_INICM + 3]).abs().max())
    # every channel the rollout carries, bit for bit
    errs["state_bit_equal"] = bool(torch.equal(out_k[:, :fr._TSAVG], out_p[:, :fr._TSAVG]))
    return ok and (same_small or not need_small), errs


def _kernel_row_sums(terms):
    """sum_j terms[..., j] over the last axis, (n, 3, V, V) -> (n, 3, V), in
    the order the dense pair pass sums a row (csrc/pair_contact.cuh): from
    zero, one term at a time, ascending j. The pairs that do not touch give
    zero terms, which leave a sum as it is, so each row's nonzero terms are
    moved to the front in order and added in turn."""
    import torch

    n, C, V, _ = terms.shape
    acc = torch.zeros((n * V, C), dtype=terms.dtype, device=terms.device)
    live = (terms != 0).any(1).reshape(n * V, V)
    rows = live.any(-1).nonzero().squeeze(1)
    if rows.numel():
        hot = live[rows]
        rank = hot.to(torch.int32).cumsum(-1, dtype=torch.int32) - 1
        K = int(rank[:, -1].max()) + 1
        slot = torch.where(hot, rank, K).to(torch.int64)
        for c in range(C):
            packed = torch.zeros((rows.numel(), K + 1), dtype=terms.dtype, device=terms.device)
            packed.scatter_(1, slot, terms[:, c].reshape(n * V, V)[rows])
            col = torch.zeros_like(packed[:, 0])
            for k in range(K):
                col = col + packed[:, k]
            acc[rows, c] = col
    return acc.reshape(n, V, C).transpose(1, 2)


def _plain(fr, *args, **kw):
    """`fused_rollout_plain` as K1 is held to it: the same function, with
    each row of the pair pass, dense or compact, summed in the kernels'
    order (`_kernel_row_sums`; the plain version's own `.sum(-1)` takes
    another order, and with contact terms of ~4e4 N cancelling the momentum
    then differs in the last bits)."""
    from unittest import mock

    dense, compact = _ordered(fr)
    with mock.patch.object(fr, "pair_contact_forces_plain", dense), \
            mock.patch.object(fr, "pair_contact_forces_compact_plain", compact):
        return fr.fused_rollout_plain(*args, **kw)


def _ordered(fr):
    """The dense and the compact pair pass's plain versions with each row
    summed in the kernels' order."""
    from functools import partial

    return (partial(fr.pair_contact_forces_plain, row_sum=_kernel_row_sums),
            partial(fr.pair_contact_forces_compact_plain, row_sum=_kernel_row_sums))


def _k1_cases(torch, fr, label, args, kw, batch, coll, steps_list, time_at=None,
              phase="k1_vs_plain", tol=TOL, need_small=True, drift_only=True,
              **extra):
    """K1 against its plain version on one input (`kw` may carry controls);
    returns the records, with `extra` in each."""
    from evosoro_tpu_torch import roofline

    recs = []
    for steps in steps_list:
        before = fr.FUSED_ROLLOUT_LAUNCHES
        out_k, st_k = fr.fused_call(*args, num_steps=steps, **kw)
        torch.cuda.synchronize()
        assert fr.FUSED_ROLLOUT_LAUNCHES == before + 1
        plain_ms = []  # without contact `_plain` is the plain version itself: timed once
        out_p, st_p = _timed_once(torch, plain_ms, steps == time_at and not coll,
                                  lambda: _plain(fr, *args, num_steps=steps, **kw))
        ok, errs = _compare(torch, fr, out_k, st_k, out_p, st_p, tol, need_small)
        rec = dict(phase=phase, workload=label, batch=batch, steps=steps,
                   collision=coll, **extra, **errs)
        rec["sha256"] = _digest("/".join(
            [phase, label, f"coll={coll}", f"steps={steps}",
             *(f"{k}={v}" for k, v in extra.items())]), out_k, st_k)
        if steps == 100:
            # beyond the step-level tolerances: drift against the band
            rec.update(drift_bound_m=DRIFT_BOUND_M)
            ok = (ok or drift_only) and errs["pos"] <= DRIFT_BOUND_M
        if steps == time_at:
            rec["ms"] = _event_ms(
                torch, lambda: fr.fused_call(*args, num_steps=steps, **kw), 5)
            rec["plain_ms"] = plain_ms[0] if plain_ms else _event_ms(
                # the plain version as the port runs it
                torch, lambda: fr.fused_rollout_plain(*args, num_steps=steps, **kw), 1,
                warm=False)
            rec.update(roofline.bound(*roofline.launch_work(
                *args, st_k, kw.get("control_packed"), flags=kw["flags"],
                grid_shape=kw["grid_shape"])))
        rec["ok"] = ok
        emit(rec)
        assert ok, rec
        recs.append(rec)
    return recs


def phase_k1(torch, timed=True):
    """K1 on the bench.py 10^3 design (8 identical robots, shared body and
    table) and on the evaluator's own batch: 15 random 6^3 designs padded to
    16, a body and pair table per robot; once as the evaluator packs it and
    once with dt, stop time and IniCM time made different for every robot.
    Returns the evaluator-batch records."""
    from evosoro_tpu_torch.bench import evaluator_workload, packed_workload
    from evosoro_tpu_torch.ops import fused_rollout as fr

    for coll in (False, True):
        args, kw, _ = packed_workload(8, collision=coll, device="cuda")
        _k1_cases(torch, fr, "bench 10^3, shared body", args, kw, 8, coll,
                  (1, 25, 100))
    recs = []
    for coll in (False, True):
        for stagger in (False, True):
            args, kw = evaluator_workload(collision=coll, stagger=stagger,
                                          device="cuda")
            assert args[1].shape[0] == args[0].shape[0] > 1  # a body per robot
            if coll:
                assert args[3].shape[0] == args[0].shape[0]  # a table per robot
            if stagger:
                assert len(set(args[2][:, fr._S_DT].tolist())) == args[0].shape[0]
            label = ("evaluator batch 6^3, "
                     + ("dt, stop and IniCM time per robot" if stagger else "as packed"))
            recs += _k1_cases(torch, fr, label, args, kw, args[0].shape[0], coll,
                              (1, 25, 100),
                              time_at=25 if timed and coll and not stagger else None)
    return recs


def _with_drag(args, coefficient):
    """The launch's tensors with every robot's drag coefficient replaced."""
    from evosoro_tpu_torch.ops import fused_rollout as fr

    stats = args[2].clone()
    stats[:, fr._S_DRAGC] = coefficient
    return (args[0], args[1], stats, args[3])


def _fluid_guards(torch, fr, label, model, args, kw, steps=100):
    """What the comparison can see: the other drag model on the same grid
    (where the grid has the shell both need) and a launch without drag, each
    against this model's plain version, beside the kernel's own error
    (largest momentum difference). At the experiment's drag coefficient a
    100-step swim moves the momenta by about as much as two float32 paths
    part anyway, so those numbers are reported; at `STRONG_DRAG` the kernel
    must still agree with its plain version, and both guards must fail the
    stated tolerances and stand `GUARD_RATIO` times above the kernel's
    error."""
    tol = MESH_TOL if model == "mesh" else TOL
    X, Y, Z = kw["grid_shape"]
    shelled = fr.has_corner_shell(args[1][:, fr._B_OCC].reshape(-1, X, Y, Z) > 0.5)
    other = dict(kw, flags=dict(kw["flags"], fluid_mesh=model != "mesh"))

    def lin_diff(a, b):
        return float((a[:, fr._LIN:fr._LIN + 3] - b[:, fr._LIN:fr._LIN + 3]).abs().max())

    rec = dict(phase="k1_fluid_guards", workload=label, model=model, steps=steps,
               ratio_needed=GUARD_RATIO, other_model_run=shelled)
    for name, cargs in (("experiment_drag", args), ("strong_drag", _with_drag(args, STRONG_DRAG))):
        out_k, st_k = fr.fused_call(*cargs, num_steps=steps, **kw)
        out_p, st_p = _plain(fr, *cargs, num_steps=steps, **kw)
        out_0, st_0 = fr.fused_call(*_with_drag(cargs, 0.0), num_steps=steps, **kw)
        torch.cuda.synchronize()
        # small_angle is held at the experiment's drag for both models
        ok, errs = _compare(torch, fr, out_k, st_k, out_p, st_p, tol,
                            model != "mesh" or name == "experiment_drag")
        err = lin_diff(out_k, out_p)
        sub = dict(kernel_vs_plain_ok=ok, kernel_linmom_err=err,
                   kernel_quat_err=errs["quat"],
                   small_angle_equal=errs["small_angle_equal"],
                   largest_linmom=float(out_p[:, fr._LIN:fr._LIN + 3].abs().max()),
                   no_drag_effect=lin_diff(out_0, out_p),
                   no_drag_passes=_compare(torch, fr, out_0, st_0, out_p, st_p, tol, False)[0])
        effects = [sub["no_drag_effect"]]
        if shelled:
            out_o, st_o = fr.fused_call(*cargs, num_steps=steps, **other)
            sub.update(other_model_effect=lin_diff(out_o, out_p),
                       other_model_passes=_compare(torch, fr, out_o, st_o, out_p, st_p,
                                                   tol, False)[0])
            effects.append(sub["other_model_effect"])
        sub["guards_seen"] = min(effects) >= GUARD_RATIO * max(err, 1e-12)
        rec[name] = sub
    strong = rec["strong_drag"]
    rec["ok"] = bool(rec["experiment_drag"]["kernel_vs_plain_ok"]
                     and strong["kernel_vs_plain_ok"] and strong["guards_seen"]
                     and not strong["no_drag_passes"]
                     and not strong.get("other_model_passes", False))
    emit(rec)
    assert rec["ok"], rec
    return rec


def phase_k1_fluid(torch):
    """K1's fluid variants against the plain version (the eager step with
    `_fluid_drag`, or with `mesh_drag_forces` over gather tables): the bench
    design in its shell (8 x 11^3, a shared body) and the swimming
    experiment's own batch (16 x 6^3 for the face model, 16 x 7^3 with the
    shell for the mesh model; a body, pair table and dt per robot, IniCM
    times staggered so the robots actuate), contact off and on, at 1, 25 and
    100 steps; with contact on also 100 steps at `STRONG_DRAG`; then the
    guards. Returns the records by model; the timed one is the mesh model on
    the evaluator's batch, 25 steps, contact on."""
    from evosoro_tpu_torch.bench import evaluator_workload, packed_workload
    from evosoro_tpu_torch.ops import fused_rollout as fr

    recs = dict(face=[], mesh=[])
    for model in ("face", "mesh"):
        tol = MESH_TOL if model == "mesh" else TOL
        opts = dict(phase="k1_fluid_vs_plain", tol=tol, drift_only=False, model=model)
        # drag as strong as elasticity, with the pair pass in the step: the
        # facet drag's sums part in the last bits there, so small_angle is
        # reported and the other groups are held
        strong = dict(opts, need_small=model != "mesh", drag=STRONG_DRAG)
        before = fr.FUSED_ROLLOUT_FLUID_LAUNCHES, fr.FUSED_ROLLOUT_MESH_LAUNCHES
        for coll in (False, True):
            args, kw, _ = packed_workload(8, collision=coll, device="cuda", fluid=model)
            assert kw["grid_shape"] == (11, 11, 11) and kw["flags"]["fluid"]
            assert kw["flags"]["fluid_mesh"] == (model == "mesh")
            label = "bench 10^3 in its 11^3 shell, shared body"
            recs[model] += _k1_cases(torch, fr, label, args, kw, 8, coll,
                                     (1, 25), **opts)
            if coll:
                recs[model] += _k1_cases(torch, fr, label, _with_drag(args, STRONG_DRAG),
                                         kw, 8, coll, (100,), **strong)
            else:
                _fluid_guards(torch, fr, label, model, args, kw)
            args, kw = evaluator_workload(
                collision=coll, stagger=True, device="cuda", experiment="swimming",
                drag_model="mesh" if model == "mesh" else "voxel_face")
            grid = kw["grid_shape"]
            assert grid == ((7, 7, 7) if model == "mesh" else (6, 6, 6)), grid
            assert args[1].shape[0] == args[0].shape[0] > 1  # a body per robot
            label = "swimming evaluator batch %d x %d^3, a body per robot" % (
                args[0].shape[0], grid[0])
            recs[model] += _k1_cases(
                torch, fr, label, args, kw, args[0].shape[0], coll, (1, 25, 100),
                time_at=25 if coll and model == "mesh" else None, **opts)
            if coll:
                recs[model] += _k1_cases(torch, fr, label, _with_drag(args, STRONG_DRAG),
                                         kw, args[0].shape[0], coll, (100,), **strong)
            else:
                _fluid_guards(torch, fr, label, model, args, kw)
        assert fr.FUSED_ROLLOUT_FLUID_LAUNCHES > before[0]
        assert fr.FUSED_ROLLOUT_MESH_LAUNCHES > before[1]  # the guards launch both
    return recs


def phase_k1_devo(torch):
    """K1's development variant against the plain version: the bench design
    with random initial and final sizes, growth windows, final phase offsets
    and amplitude dampings (8 x 10^3, IniCM time at step 30; without and
    with a mid-life freeze of 20 steps), and the growth experiment's own
    batch (16 x 5x5x4, sizes and windows from `devo_params_from_vxa`, a body
    per robot), contact off and on, at 1, 25 and 100 steps. Guard: the same
    tensors with the development flags cleared must fail the comparison.
    Returns the records; the timed one is the evaluator's batch, 25 steps,
    contact on."""
    from evosoro_tpu_torch.bench import evaluator_workload, packed_workload
    from evosoro_tpu_torch.ops import fused_rollout as fr

    recs = []
    opts = dict(phase="k1_devo_vs_plain", drift_only=False)
    before = fr.FUSED_ROLLOUT_DEVO_LAUNCHES

    def guard(label, args, kw):
        land = dict(kw, flags=dict(kw["flags"], **{k: False for k in fr._K1_DEVO_FLAGS}))
        out_l, st_l = fr.fused_call(*args, num_steps=100, **land)
        out_p, st_p = _plain(fr, *args, num_steps=100, **kw)
        passes, errs = _compare(torch, fr, out_l, st_l, out_p, st_p)
        rec = dict(phase="k1_devo_guard", workload=label, steps=100,
                   flags_cleared_passes=passes, scale_diff=errs["scale"],
                   grown_by=float((out_p[:, fr._SCALE] - 0.01).abs().max()))
        emit(rec)
        assert not passes and rec["grown_by"] > 1e-4, rec

    for freeze in (False, True):
        args, kw, _ = packed_workload(8, device="cuda", devo=True, freeze=freeze)
        assert all(kw["flags"][k] for k in fr._K1_DEVO_FLAGS)
        assert kw["flags"]["freeze_on"] == freeze
        label = "bench 10^3 with growth fields" + (", mid-life freeze" if freeze else "")
        recs += _k1_cases(torch, fr, label, args, kw, 8, False, (1, 25, 100),
                          freeze=freeze, **opts)
        guard(label, args, kw)
    for coll in (False, True):
        args, kw = evaluator_workload(collision=coll, stagger=True, device="cuda",
                                      experiment="growth")
        assert kw["grid_shape"] == (5, 5, 4) and kw["flags"]["use_final_size"]
        assert args[1].shape[0] == args[0].shape[0] > 1
        label = "growth evaluator batch %d x 5x5x4, a body per robot" % args[0].shape[0]
        recs += _k1_cases(torch, fr, label, args, kw, args[0].shape[0], coll,
                          (1, 25, 100), time_at=25 if coll else None, **opts)
        if not coll:
            guard(label, args, kw)
    assert fr.FUSED_ROLLOUT_DEVO_LAUNCHES > before
    return recs


# K1's fitness features against the plain version (`phase_k1_features`).
# Counters, latches and the channels made of minima and of sums taken one
# robot-scalar at a time: equal. The sums over voxels (CoM y and volume of
# a trace sample, so NormDistByVol and the window distances; the needle's
# position): rtol 1e-5 and 1e-6 lattice units, since K1 and torch add the
# voxels in other orders. Ballistic development's channels 56-59: rtol 1e-6.
FEAT_EXACT = dict(trace_count=(35, 36), trace_time=(36, 37), window_count=(39, 40),
                  window_time=(40, 41), fell=(29, 30), needle_captured=(44, 45),
                  eol_captured=(46, 47), eol_y=(45, 46), source_min=(22, 25),
                  source_sum=(25, 28), source_count=(28, 29))
FEAT_SUMS = dict(norm_dist=(32, 33), regime=(33, 34), frozen=(34, 35),
                 window_last=(37, 38), window_prev=(38, 39), needle=(41, 44))
FEAT_RTOL, FEAT_ATOL = 1e-5, 1e-6
DEVO_RTOL = 1e-6
# which channel groups each feature's guard must move
FEAT_GUARDS = dict(needle=("needle", "needle_captured"), falling=("fell",),
                   ndbv=("norm_dist",), window=("window_last", "window_count"),
                   sources=("source_min", "source_sum", "source_count"))


def _feat_compare(torch, st_k, st_p):
    """Per channel group of the stats rows: (passes, largest difference)."""
    out = {}
    for name, (a, b) in FEAT_EXACT.items():
        d = (st_k[:, a:b] - st_p[:, a:b]).abs()
        out[name] = (bool(torch.equal(st_k[:, a:b], st_p[:, a:b])), float(d.max()))
    for name, (a, b) in FEAT_SUMS.items():
        d = (st_k[:, a:b] - st_p[:, a:b]).abs()
        out[name] = (bool((d <= FEAT_ATOL + FEAT_RTOL * st_p[:, a:b].abs()).all()),
                     float(d.max()))
    return out


def _line_workload(torch, fr, V):
    """One robot, a row of V muscle voxels with its pair table, contact and
    the needle and fall-over features on: the packed launch arguments."""
    import numpy as np

    from evosoro_tpu_torch.core import (build_body, calc_max_dt, evosoro_default_palette,
                                        init_state, palette_from_list)
    from evosoro_tpu_torch.core.collision import build_collision_system
    from evosoro_tpu_torch.core.types import EnvParams, SimParams

    structure = np.full((V, 1, 1), 3, dtype=np.int32)
    body = build_body(structure, palette_from_list(evosoro_default_palette()), device="cuda")
    sim = SimParams(self_collisions_enabled=True)
    env = EnvParams(needle_in_haystack=True, falling_prohibited=True)
    table = torch.as_tensor(fr.pack_collision(build_collision_system(
        structure, body.e_mod.cpu().numpy(), 0.01), (V, 1, 1)), device="cuda")[None]
    args = (fr.pack_state_single(init_state(body))[None].contiguous(), fr.pack_body(body),
            fr.make_stats(body, 1, calc_max_dt(body) * 0.9, sim, env), table)
    return args, dict(grid_shape=(V, 1, 1), scalars=fr.kernel_scalars(0.01, sim, env),
                      flags=fr.launch_flags(body, sim, env, collision=True))


def phase_k1_features(torch):
    """K1's feature instance against the plain version, on the evaluator's
    own batch (`bench.feature_workload`: 16 x 6^3, a body, pair table and dt
    per robot, contact on, mat-6 feet and a mat-7 needle in the designs,
    half the robots falling over): NormDistByVol with the mid-life freeze's
    window and the afterlife regime, the fall-over latch, the needle,
    windows of 4 trace steps with 3 sources (one oscillating) and of 12 with
    1, at 1 and 240 steps (a trace every 6 steps: 38 traces, 10 and 4
    windows). Then ballistic development on the growth batch
    (`bench.ballistic_workload`, contact on, 240 steps), the facet-drag variant's feature
    instance on the swimming batch (100 steps) and the shared-memory ceiling.
    Guards: each feature's bit off must fail its channels. Then each
    branch's launch time and the bookkeeping's cost on 1024 x 10^3 x 200
    steps. Returns (the comparison records, the timed records)."""
    from evosoro_tpu_torch import roofline
    from evosoro_tpu_torch.bench import (ballistic_workload, evaluator_workload,
                                         feature_workload, packed_workload, time_call,
                                         with_features)
    from evosoro_tpu_torch.ops import fused_rollout as fr

    before = fr.FUSED_ROLLOUT_FEATURE_LAUNCHES
    recs = []
    for n_win, n_src in ((4, 3), (12, 1)):
        args, kw = feature_workload(n_win=n_win, n_src=n_src, device="cuda")
        B = args[0].shape[0]
        for steps in (1, 240):
            out_k, st_k = fr.fused_call(*args, num_steps=steps, **kw)
            out_p, st_p = _plain(fr, *args, num_steps=steps, **kw)
            torch.cuda.synchronize()
            ok, errs = _compare(torch, fr, out_k, st_k, out_p, st_p)
            groups = _feat_compare(torch, st_k, st_p)
            rec = dict(phase="k1_features_vs_plain", workload="evaluator batch %d x 6^3, "
                       "contact on, features" % B, n_win=n_win, n_src=n_src, steps=steps,
                       **errs, **{k: v[1] for k, v in groups.items()},
                       groups_failing=[k for k, v in groups.items() if not v[0]],
                       robots_fallen=int((st_p[:, fr._S_FELL] > 0.5).sum()),
                       traces_max=float(st_p[:, fr._S_NTR].max()),
                       windows_max=float(st_p[:, fr._S_WCNT].max()))
            rec["sha256"] = _digest("k1_features/n_win=%d/n_src=%d/steps=%d"
                                    % (n_win, n_src, steps), out_k, st_k)
            if steps == 240:
                assert rec["robots_fallen"] > 0 and rec["traces_max"] >= 6 and rec["windows_max"] >= 2, rec
                for name in ("regime", "frozen"):
                    a, b = FEAT_SUMS[name]
                    assert float(st_p[:, a:b].abs().max()) > 0, (name, rec)
                if n_win == 4:
                    for name, flag in (("needle", "needle"), ("falling", "falling"),
                                       ("ndbv", "ndbv"), ("window", "window"),
                                       ("sources", None)):
                        if flag == "window":
                            off = dict(kw, flags=dict(kw["flags"], window=False, n_win=0))
                        elif flag is None:
                            off = dict(kw, scalars=dict(kw["scalars"], sources=()))
                        else:
                            off = dict(kw, flags=dict(kw["flags"], **{flag: False}))
                        _, st_g = fr.fused_call(*args, num_steps=steps, **off)
                        g = _feat_compare(torch, st_g, st_p)
                        moved = {k: g[k][1] for k in FEAT_GUARDS[name]}
                        rec[f"guard_{name}"] = moved
                        assert all(not g[k][0] for k in FEAT_GUARDS[name]), (name, moved)
            rec["ok"] = ok and not rec["groups_failing"]
            emit(rec)
            assert rec["ok"], rec
            recs.append(rec)

    # ballistic development on the growth batch, contact on as the
    # ballistic experiment runs it
    args, kw = ballistic_workload(device="cuda")
    assert args[3] is not None and kw["flags"]["collision"]
    steps = 240
    b0 = fr.FUSED_ROLLOUT_BALLISTIC_LAUNCHES
    out_k, st_k = fr.fused_call(*args, num_steps=steps, **kw)
    out_p, st_p = _plain(fr, *args, num_steps=steps, **kw)
    off = dict(kw, flags=dict(kw["flags"], ballistic=False))
    out_0, _ = fr.fused_call(*args, num_steps=steps, **off)
    torch.cuda.synchronize()
    assert fr.FUSED_ROLLOUT_BALLISTIC_LAUNCHES == b0 + 1
    ok, errs = _compare(torch, fr, out_k, st_k, out_p, st_p)
    dd = slice(fr._DEVO_DYN, fr._DEVO_DYN + 4)
    d_devo = (out_k[:, dd] - out_p[:, dd]).abs()
    devo_ok = bool((d_devo <= DEVO_RTOL * out_p[:, dd].abs()).all())
    rebased = ((out_p[:, dd] - args[0][:, dd]).abs().flatten(1).amax(1) > 0)
    groups = _feat_compare(torch, st_k, st_p)
    d_off = (out_0[:, dd] - out_p[:, dd]).abs()
    rec = dict(phase="k1_ballistic_vs_plain", workload="growth evaluator batch %d x 5x5x4, "
               "contact on" % args[0].shape[0], steps=steps, **errs, devo_err=float(d_devo.max()),
               robots_rebased=int(rebased.sum()),
               windows_max=float(st_p[:, fr._S_WCNT].max()),
               without_ballistic_devo_diff=float(d_off.max()),
               without_ballistic_passes=bool((d_off <= DEVO_RTOL * out_p[:, dd].abs()).all()),
               groups_failing=[k for k in ("window_last", "window_prev", "window_count",
                                           "trace_count") if not groups[k][0]])
    rec["sha256"] = _digest("k1_ballistic/steps=%d" % steps, out_k, st_k)
    rec["ok"] = (ok and devo_ok and rec["robots_rebased"] > 0 and not rec["groups_failing"]
                 and not rec["without_ballistic_passes"])
    emit(rec)
    assert rec["ok"], rec
    recs.append(rec)

    # the feature instance of the facet-drag variant: the swimming batch in
    # its shell, contact on, the needle, NormDistByVol, windows of 4 and 2
    # sources; the facet sums part in the last bits (MESH_TOL)
    (st_w, bo_w, sa_w, tb_w), kw_w = evaluator_workload(
        collision=True, stagger=True, device="cuda", experiment="swimming")
    kw_w = with_features(kw_w, sa_w, n_win=4, n_src=2, freeze=False)
    args_w = (st_w, bo_w, sa_w, tb_w)
    out_k, st_k = fr.fused_call(*args_w, num_steps=100, **kw_w)
    out_p, st_p = _plain(fr, *args_w, num_steps=100, **kw_w)
    torch.cuda.synchronize()
    ok, errs = _compare(torch, fr, out_k, st_k, out_p, st_p, MESH_TOL)
    groups = _feat_compare(torch, st_k, st_p)
    failing = [k for k in ("trace_count", "window_count", "needle_captured", "source_count",
                           "norm_dist", "window_last", "needle") if not groups[k][0]]
    rec = dict(phase="k1_features_in_water", workload="swimming evaluator batch 16 x 7^3, "
               "facet drag, contact on", steps=100, **errs,
               **{k: groups[k][1] for k in ("norm_dist", "window_last", "source_min")},
               groups_failing=failing, traces_max=float(st_p[:, fr._S_NTR].max()),
               ok=ok and not failing)
    emit(rec)
    assert rec["ok"] and rec["traces_max"] >= 3, rec

    # the shared-memory ceiling with contact: a 1339-cell body launches the
    # feature instance (its static shared memory is the largest) in shared
    # memory, 1340 its device-memory twin; both against the plain version
    rec = dict(phase="k1_ceiling", device_launches={}, errs={})
    for V in (1339, 1340):
        a, k = _line_workload(torch, fr, V)
        g0 = fr.FUSED_ROLLOUT_GMEM_LAUNCHES
        out_k, st_k = fr.fused_call(*a, num_steps=25, **k)
        torch.cuda.synchronize()
        rec["device_launches"][V] = fr.FUSED_ROLLOUT_GMEM_LAUNCHES - g0
        ok, rec["errs"][V] = _compare(torch, fr, out_k, st_k,
                                      *_plain(fr, *a, num_steps=25, **k))
        assert ok, rec
    emit(rec)
    assert rec["device_launches"] == {1339: 0, 1340: 1}, rec

    # each branch's launch, timed at 25 steps: the trace, needle and
    # fall-over bookkeeping without sources (B8c), the sources alone (B8d),
    # ballistic development (B8b)
    timed = {}
    args_c, kw_c = feature_workload(n_win=4, n_src=0, device="cuda")
    args_d, kw_d = feature_workload(n_win=0, n_src=3, device="cuda", needle=False,
                                    falling=False, ndbv=False)
    for name, (a, k) in dict(b8c=(args_c, kw_c), b8d=(args_d, kw_d),
                             b8b=(args, kw)).items():
        rec = dict(phase="k1_feature_branch_time", branch=name, batch=a[0].shape[0],
                   steps=25, ms=_event_ms(torch, lambda: fr.fused_call(*a, num_steps=25, **k), 5),
                   plain_ms=_event_ms(torch, lambda: fr.fused_rollout_plain(
                       *a, num_steps=25, **k), 1, warm=False))
        _, st25 = fr.fused_call(*a, num_steps=25, **k)
        rec.update(roofline.bound(*roofline.launch_work(
            *a, st25, flags=k["flags"], grid_shape=k["grid_shape"], scalars=k["scalars"])))
        emit(rec)
        timed[name] = rec

    # the bookkeeping's cost: 1024 x 10^3 x 200 steps, every feature on
    # (NormDistByVol, windows of 12, the latch, the needle, 3 sources)
    # beside none, in turns
    args, kw, _ = packed_workload(1024, device="cuda")
    stats = args[2].clone()
    stats[:, fr._S_INITCM] = 10 * stats[:, fr._S_DT]
    args = (args[0], args[1], stats, args[3])
    feat = with_features(kw, stats, n_win=12, n_src=3, freeze=False)

    def run(k):
        return lambda: fr.fused_call(*args, num_steps=200, **k)

    t_none, t_feat = [], []
    for k, acc in ((kw, t_none), (feat, t_feat), (feat, t_feat), (kw, t_none)):
        acc.append(time_call(run(k), groups=2, reps=3))
    _, st_f = run(feat)()
    work = [roofline.b8c_work(args[1], stats, st_f, feat["flags"]),
            roofline.b8d_work(args[1], stats, st_f, 3)]
    fb = roofline.bound(sum(w[0] for w in work), sum(w[1] for w in work))
    rec = dict(phase="k1_features_cost", workload="bench 1024 x 10^3 x 200 steps",
               ms_without=min(t_none), ms_with=min(t_feat),
               ms_without_all=t_none, ms_with_all=t_feat,
               added_ms=min(t_feat) - min(t_none),
               feature_bound_ms=fb["bound_ms"], feature_bound_by=fb["bound_by"],
               share_of_feature_bound=fb["bound_ms"] / max(min(t_feat) - min(t_none), 1e-9))
    emit(rec)
    timed["cost"] = rec
    assert fr.FUSED_ROLLOUT_FEATURE_LAUNCHES > before
    return recs, timed


# the JAX package's tolerances between its kernel and its jnp step for the
# material instance's branches (tests/test_fused_rollout.py:381-682); a
# launch with several branches on is held at the strictest of theirs
MAT_TOL = dict(
    nonlinear=dict(pos=(2e-4, 5e-8), time=(1e-6, 0.0)),
    plasticity=dict(pos=(2e-4, 2e-8), time=(1e-6, 0.0)),
    max_vel=dict(pos=(5e-5, 1e-8), time=(1e-6, 0.0)),
    bc=dict(pos=(2e-5, 1e-9), linmom=(1e-3, 1e-10), time=(1e-6, 0.0)),
    equilibrium=dict(pos=(2e-5, 1e-8), linmom=(1e-3, 1e-10), time=(1e-6, 0.0)),
)
SOFF_RTOL = 1e-4  # plasticity's strain offset
KE_RTOL = 1e-3  # equilibrium mode's kinetic-energy ring


def _strictest(*names):
    out = {}
    for n in names:
        for k, (r, a) in MAT_TOL[n].items():
            out[k] = (min(r, out[k][0]), min(a, out[k][1])) if k in out else (r, a)
    return out


def _mat_case(torch, fr, label, args, kw, steps, tol, guards, extra_check=None,
              time_steps=None, **info):
    """K1's material instance against its plain version on one input, with
    guards: each (name, launch keywords[, tensors]) is the same launch with
    a branch's bit off, which must fail `tol`; with `time_steps`, a launch of that many
    steps timed beside its plain version and its bound. Returns the record."""
    from evosoro_tpu_torch import roofline

    before = fr.FUSED_ROLLOUT_MATERIAL_LAUNCHES
    out_k, st_k = fr.fused_call(*args, num_steps=steps, **kw)
    torch.cuda.synchronize()
    assert fr.FUSED_ROLLOUT_MATERIAL_LAUNCHES == before + 1
    out_p, st_p = _plain(fr, *args, num_steps=steps, **kw)
    torch.cuda.synchronize()
    ok, errs = _compare(torch, fr, out_k, st_k, out_p, st_p, tol)
    rec = dict(phase="k1_materials_vs_plain", workload=label, batch=args[0].shape[0],
               steps=steps, tol=tol, **info, **errs)
    for name, gkw, *gargs in guards:
        # a guard passes only if every check of the case passes on it
        out_g, st_g = fr.fused_call(*(gargs[0] if gargs else args), num_steps=steps, **gkw)
        g_ok, g_errs = _compare(torch, fr, out_g, st_g, out_p, st_p, tol, need_small=False)
        if extra_check is not None:
            g_ok &= extra_check({}, out_g, st_g, out_p, st_p)
        rec[f"guard_{name}_pos"] = g_errs["pos"]
        rec[f"guard_{name}_passes"] = g_ok
        ok &= not g_ok
    if extra_check is not None:
        ok &= extra_check(rec, out_k, st_k, out_p, st_p)
    rec["sha256"] = _digest("k1_materials/%s/steps=%d" % (label, steps), out_k, st_k)
    if time_steps:
        n = time_steps
        rec["timed_steps"] = n
        rec["ms"] = _event_ms(torch, lambda: fr.fused_call(*args, num_steps=n, **kw), 5)
        rec["plain_ms"] = _event_ms(
            torch, lambda: fr.fused_rollout_plain(*args, num_steps=n, **kw), 1, warm=False)
        _, st_n = fr.fused_call(*args, num_steps=n, **kw)
        ss = kw.get("ss_packed")
        rec.update(roofline.bound(*roofline.launch_work(
            *args, st_n, flags=kw["flags"], grid_shape=kw["grid_shape"],
            scalars=kw["scalars"], n_pts=0 if ss is None else (ss.shape[1] - 3) // 2)))
    rec["ok"] = ok
    emit(rec)
    assert ok, rec
    return rec


def _compact_pass_check(torch, fr, label, pos, scale, table_c, table_d):
    """The compact pass's own launch (`fr.pair_contact_forces_compact`,
    K1's pass alone) on these positions and scales: equal bit for bit to
    its plain version and to the dense pass's (table `table_d`), each
    summing a row in the kernels' order, and its tile counts equal to the
    plain census over the index row. Returns the record."""
    from evosoro_tpu_torch import roofline

    dense, compact = _ordered(fr)
    counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    before = fr.PAIR_CONTACT_COMPACT_LAUNCHES
    f_k = fr.pair_contact_forces_compact(pos, scale, table_c, counts=counts)
    torch.cuda.synchronize()
    assert fr.PAIR_CONTACT_COMPACT_LAUNCHES == before + 1
    f_p, f_d = compact(pos, scale, table_c), dense(pos, scale, table_d)
    got = tuple(int(c) for c in counts.cpu())
    want = fr.pair_tile_census_plain(pos.cpu(), scale.cpu(), table_c[:, 1:].cpu(),
                                     idx=table_c[:, 0].cpu())
    fmax = float(f_p.abs().max())
    rec = dict(phase="compact_pass", workload=label, shape=list(pos.shape),
               surface_voxels=table_c.shape[-1], max_abs_force=fmax,
               max_abs_err=float((f_k - f_p).abs().max()),
               equal_to_plain=bool(torch.equal(f_k, f_p)),
               equal_to_dense_plain=bool(torch.equal(f_k, f_d)),
               tiles=list(got), plain_census=list(want), tiles_equal=got == want,
               ms=_event_ms(torch, lambda: fr.pair_contact_forces_compact(pos, scale, table_c),
                            20),
               plain_ms=_event_ms(torch, lambda: fr.pair_contact_forces_compact_plain(
                   pos, scale, table_c), 5),
               **roofline.bound(*roofline.b5_pass_work(pos, scale, table_c)))
    rec["ok"] = (fmax > 0 and rec["equal_to_plain"] and rec["equal_to_dense_plain"]
                 and rec["tiles_equal"])
    emit(rec)
    assert rec["ok"], rec
    return rec


def _compact_case(torch, np, fr, label, a_c, kw_c, a_d, kw_d, time_steps=None):
    """K1's compact contact pass on launches `a_c` (compact table) and `a_d`
    (dense table) of one design whose lattice is shrunk about its centre so
    that far surface voxels touch: against its plain version in the
    kernels' order, one step (its momenta carry the contact forces times
    dt), held to K2's rule max |df| <= 1e-4 max |f| with the state's bits
    reported, contact off failing; against the dense pass, the same launch
    on the dense table, state and stats equal; and the pass's own launch on
    the shrunk state (`_compact_pass_check`). Returns the record, with the
    dense comparison under `dense_vs_compact` and the pass's under `pass`."""
    state = a_c[0].clone()
    state[:, fr._POS:fr._POS + 3] = _contact_positions(
        torch, np, state[:, fr._POS:fr._POS + 3], 0.5)
    a_c, a_d = (state,) + a_c[1:], (state,) + a_d[1:]
    before = fr.FUSED_ROLLOUT_COMPACT_LAUNCHES
    lin = slice(fr._LIN, fr._LIN + 3)

    def force_check(rec, out_k, st_k, out_p, st_p):
        top = float(out_p[:, lin].abs().max())
        rec["momentum_rel_err"] = float((out_k[:, lin] - out_p[:, lin]).abs().max()) / top
        return rec["momentum_rel_err"] <= K2_REL_TOL

    no_lin = {k: v for k, v in TOL.items() if k != "linmom"}
    rec = _mat_case(torch, fr, label, a_c, kw_c, 1, no_lin,
                    [("contact", dict(kw_c, flags=dict(kw_c["flags"], collision=False,
                                                       collision_compact=False)),
                      a_c[:3] + (None,))],
                    force_check, time_steps=time_steps, surface_voxels=a_c[3].shape[-1])
    assert fr.FUSED_ROLLOUT_COMPACT_LAUNCHES > before
    equal = {}
    for steps in (1, 25):
        out_c, st_c = fr.fused_call(*a_c, num_steps=steps, **kw_c)
        out_d, st_d = fr.fused_call(*a_d, num_steps=steps, **kw_d)
        equal[steps] = bool(torch.equal(out_c, out_d) and torch.equal(st_c, st_d))
    rec_cd = dict(phase="compact_vs_dense_k1", workload=label, bit_equal_by_steps=equal,
                  dense_instance="material" if any(
                      kw_d["flags"].get(k) for k in fr._K1_MAT_FLAGS) else "land")
    rec_cd["ok"] = all(equal.values())
    emit(rec_cd)
    assert rec_cd["ok"], rec_cd
    pass_rec = _compact_pass_check(torch, fr, label, state[:, fr._POS:fr._POS + 3].contiguous(),
                                   state[:, fr._SCALE].contiguous(), a_c[3], a_d[3])
    return dict(rec, dense_vs_compact=rec_cd, **{"pass": pass_rec})


def phase_k1_materials(torch, np, replays):
    """K1's material instance (Voxelyze's material, solver and boundary
    options, and the surface-compacted contact pass) against its plain
    version: (a) the evaluator's batch of the materials experiment
    (bilinear muscle, MDL_DATA tissue, 16 x 6^3, a body, table and dt per
    robot, contact on) with plasticity and the max-velocity clamp, 25 and
    100 steps, and with every fitness feature; (b) equilibrium mode on the
    bench design, 8 x 10^3, held over steps 400-500, in which the zeroing
    fires (at step 478); (c) the
    hand-written 10^3 cantilever read with `load_vxa`, whose pinned face
    stays at its nominal place bit for bit; (d) the four fixture .vxa files
    as `phase_replay` replayed them whole, dense and compact (`replays`, its
    records), whose fitnesses must agree at K2's tolerance, and on each
    design's lattice shrunk into contact K1's compact pass held against its
    plain version and the dense pass (`_compact_case`), then the same on the
    bench design, timed; then B5's and B6's times on 1024 x 10^3. Guards:
    each branch's bit off fails its tolerance. Returns the records by
    name."""
    import tempfile

    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.ops import fused_rollout as fr

    recs = {}
    # (a)
    args, kw = bench.materials_workload(device="cuda")
    off = lambda **f: dict(kw, flags=dict(kw["flags"], **f))  # noqa: E731
    soff = slice(fr._SOFF, fr._SOFF + 3)

    def soff_check(rec, out_k, st_k, out_p, st_p):
        d = (out_k[:, soff] - out_p[:, soff]).abs()
        rec["strain_offset_err"] = float(d.max())
        rec["strain_offset_max"] = float(out_p[:, soff].abs().max())
        return bool((d <= 1e-7 + SOFF_RTOL * out_p[:, soff].abs()).all()) \
            and rec["strain_offset_max"] > 0

    tol_a = _strictest("nonlinear", "plasticity", "max_vel")
    recs["a"] = [_mat_case(torch, fr, "materials evaluator batch 6^3, contact on", args, kw,
                           steps, tol_a,
                           [("nonlinear", dict(off(nonlinear=False, mdl_data=False),
                                               ss_packed=None)),
                            ("plasticity", off(plasticity=False)),
                            ("max_vel", off(max_vel=False))],
                           soff_check, time_steps=25 if steps == 25 else None)
                 for steps in (25, 100)]
    fkw = bench.with_features(kw, args[2], n_win=4, n_src=1)
    recs["a_features"] = _mat_case(
        torch, fr, "materials evaluator batch 6^3, contact on, features", args, fkw, 100,
        tol_a, [("plasticity", dict(fkw, flags=dict(fkw["flags"], plasticity=False)))],
        soff_check)

    # (b)
    args, kw, _ = bench.packed_workload(8, device="cuda", equilibrium=True)
    ke = slice(fr._S_KE, fr._S_KE + 6)

    def energy(out):  # the robots' kinetic energy, 0.5 sum(p^2 / m + L^2 / I)
        b = args[1][0]
        lin = (out[:, fr._LIN:fr._LIN + 3] ** 2).sum(1) * b[fr._B_MASS_INV]
        ang = (out[:, fr._ANG:fr._ANG + 3] ** 2).sum(1) * b[fr._B_INERTIA_INV]
        return 0.5 * (lin + ang).sum(1)

    def ke_check(rec, out_k, st_k, out_p, st_p):
        d = (st_k[:, ke] - st_p[:, ke]).abs()
        rec["ke_err"] = float(d.max())
        rec["ke_ring"] = st_p[0, ke].tolist()
        rec["energy_j"] = float(energy(out_k).max())
        return bool((d <= KE_RTOL * st_p[:, ke].abs()).all())

    # without the mode the same launch keeps its energy: the zeroing fired.
    # The design falls from rest, and its energy first falls at step 478
    # (the plain version on the CPU): the kernel alone takes it to step 400,
    # and the comparison runs the 100 steps after, over the zeroing
    off_b = dict(kw, flags=dict(kw["flags"], equilibrium=False),
                 scalars=fr.equilibrium_scalars(kw["scalars"]))
    st400, ss400 = fr.fused_call(*args, num_steps=400, **kw)
    rec = _mat_case(torch, fr, "bench 8 x 10^3, equilibrium mode, steps 400-500",
                    (st400, args[1], ss400, args[3]), kw, 100, MAT_TOL["equilibrium"],
                    [("equilibrium", off_b)], ke_check, time_steps=25)
    out_free, _ = fr.fused_call(*args, num_steps=500, **off_b)
    free = float(energy(out_free).min())
    emit(dict(phase="equilibrium_zeroing", energy_with_mode_j=rec["energy_j"],
              energy_without_mode_j=free))
    assert rec["energy_j"] < 0.1 * free, (rec["energy_j"], free)
    recs["b"] = dict(rec, energy_without_mode_j=free)

    # (c)
    with tempfile.TemporaryDirectory() as tmp:
        args, kw, body = bench.cantilever_workload(os.path.join(tmp, "cantilever.vxa"),
                                                   batch=2, device="cuda")
    pinned = ((body.dof_fixed == 63) & body.occ).flatten()
    nom = (body.nom_pos + body.external_disp).reshape(-1, 3).T

    def pinned_check(rec, out_k, st_k, out_p, st_p):
        rec["pinned_voxels"] = int(pinned.sum())
        rec["pinned_exact"] = all(torch.equal(o[:, :3][:, :, pinned],
                                              nom[:, pinned].expand(2, -1, -1))
                                  for o in (out_k, out_p))
        tip = (torch.arange(pinned.numel(), device=pinned.device)
               // (body.occ.shape[1] * body.occ.shape[2])) == body.occ.shape[0] - 1
        rec["tip_sag_m"] = float((nom[2, tip] - out_k[:, 2][:, tip]).mean())
        return rec["pinned_exact"] and rec["tip_sag_m"] > 0

    recs["c"] = _mat_case(torch, fr, "cantilever 10^3 (load_vxa)", args, kw, 200,
                          MAT_TOL["bc"], [("bc", dict(kw, flags=dict(kw["flags"], bc=False),
                                                      bc_packed=None))], pinned_check,
                          time_steps=25)

    # (d) the fixtures replayed whole, dense and compact (`phase_replay`'s run)
    recs["d"], recs["d_cases"] = [], []
    for path in bench.fixture_paths():
        name = os.path.basename(path)
        dense, compact = [r for r in replays if r["file"] == name]
        assert not dense["compact"] and compact["compact"], (dense, compact)
        fit_rel = abs(dense["fitness"] - compact["fitness"]) / max(abs(dense["fitness"]), 1e-30)
        a_d, kw_d = bench.replay_launch(path, batch=1, device="cuda")
        a_c, kw_c = bench.replay_launch(path, batch=1, device="cuda", compact=True)
        # the compact pass's plain version against the dense pass (K2's own
        # launch) on the design's lattice shrunk about its centre, where far
        # surface voxels touch
        pos = _contact_positions(torch, np, a_d[0][:, fr._POS:fr._POS + 3], 0.4)
        scale = a_d[0][:, fr._SCALE].contiguous()
        f_d = fr.pair_contact_forces(pos, scale, a_d[3])
        f_c = fr.pair_contact_forces_compact_plain(pos, scale, a_c[3])
        fmax = float(f_d.abs().max())
        rel = float((f_d - f_c).abs().max()) / max(fmax, 1e-30)
        # K1's compact pass at this design's shapes against its plain
        # version and the dense pass (the land instance, as the file runs)
        k1 = _compact_case(torch, np, fr, "fixture %s shrunk into contact, compact contact"
                           % name, a_c, kw_c, a_d, kw_d)
        rec = dict(phase="replay", file=name, steps=dense["steps"],
                   fitness_dense=dense["fitness"], fitness_compact=compact["fitness"],
                   fitness_rel_diff=fit_rel, fitness_in_file_name=dense["fitness_in_name"],
                   seconds_dense=dense["seconds"], seconds_compact=compact["seconds"],
                   surface_voxels=dense["surface_voxels"], voxels=dense["voxels"],
                   contact_force_max=fmax, compact_vs_dense_rel=rel,
                   k1_momentum_rel_err=k1["momentum_rel_err"],
                   k1_state_bit_equal_to_plain=k1["state_bit_equal"],
                   k1_bit_equal_to_dense=k1["dense_vs_compact"]["ok"],
                   pass_bit_equal=k1["pass"]["ok"], tol=K2_REL_TOL)
        ok = (fmax > 0 and rel <= K2_REL_TOL and fit_rel <= K2_REL_TOL
              and not dense["diverged"] and not compact["diverged"]
              and all(np.isfinite([dense["fitness"], compact["fitness"]])))
        rec["ok"] = ok
        emit(rec)
        assert ok, rec
        recs["d"].append(rec)
        recs["d_cases"].append(k1)
    # the same on the bench 10^3 design (488 surface voxels) on
    # `materials_palette`, 4 robots, both tables in the material instance,
    # timed at 25 steps from the same state
    a_c, kw_c, _ = bench.packed_workload(4, collision=True, compact=True, materials=True,
                                         device="cuda")
    a_d, kw_d, _ = bench.packed_workload(4, collision=True, materials=True, device="cuda")
    recs["b5"] = _compact_case(torch, np, fr, "bench 4 x 10^3 shrunk into contact, "
                               "compact contact", a_c, kw_c, a_d, kw_d, time_steps=25)

    # B5 against the dense pass on 1024 x 10^3 x 20 with contact, and B6's
    # cost on 1024 x 10^3 x 200 against the land instance, in turns
    t_dense, t_compact = [], []
    for compact, acc in ((False, t_dense), (True, t_compact), (True, t_compact),
                         (False, t_dense)):
        acc.append(bench.throughput(batch=1024, steps=20, collision=True, compact=compact,
                                    groups=2, reps=2))
    t_land, t_mat = [], []
    for mat, acc in ((False, t_land), (True, t_mat), (True, t_mat), (False, t_land)):
        acc.append(bench.throughput(batch=1024, steps=200, materials=mat, groups=2, reps=3))
    best = lambda rs: min(rs, key=lambda r: r["ms"])  # noqa: E731
    rec = dict(phase="materials_cost",
               b5_dense_ms=[r["ms"] for r in t_dense], b5_compact_ms=[r["ms"] for r in t_compact],
               b5_compact_over_dense=best(t_compact)["ms"] / best(t_dense)["ms"],
               b5_compact_bound_ms=best(t_compact)["bound_ms"],
               b6_land_ms=[r["ms"] for r in t_land], b6_materials_ms=[r["ms"] for r in t_mat],
               b6_added_ms=best(t_mat)["ms"] - best(t_land)["ms"],
               b6_materials_bound_ms=best(t_mat)["bound_ms"],
               b6_materials_bound_by=best(t_mat)["bound_by"])
    emit(rec)
    recs["cost"] = rec
    return recs


def phase_compact(torch, np):
    """The surface-compacted contact pass (B5, csrc/pair_contact.cuh over
    the S surface voxels, in K1's material instance) alone: (a) the bench
    design 4 x 10^3 on `materials_palette` shrunk into contact, K1's compact
    launch against its plain version in the kernels' order and against the
    dense launch in the material instance, bit for bit over 1 and 25 steps,
    and the pass's own launch bit for bit with the dense plain pass, its
    tile counts against the census (`_compact_case`, timed at 25 steps);
    (b) the same on each fixture's lattice, the dense launch in the land
    instance as the file runs; (c) the big-body batch 8 x 12^3 with contact
    in the device-memory instances; (d) the guard: a cull margin of -0.5
    drops the touching tiles of `_pair_guard_inputs` and misses K2's
    tolerance by GUARD_RATIO; (e) the replay path with the compact switch
    (the four fixtures through `bench.replay`), the counters zeroed just
    before and read just after. Returns the records."""
    from unittest import mock

    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.ops import fused_rollout as fr

    res = {}
    a_c, kw_c, _ = bench.packed_workload(4, collision=True, compact=True, materials=True,
                                         device="cuda")
    a_d, kw_d, _ = bench.packed_workload(4, collision=True, materials=True, device="cuda")
    res["b5"] = _compact_case(torch, np, fr, "bench 4 x 10^3 shrunk into contact, "
                              "compact contact", a_c, kw_c, a_d, kw_d, time_steps=25)
    res["fixtures"] = []
    for path in bench.fixture_paths():
        a_d, kw_d = bench.replay_launch(path, batch=1, device="cuda")
        a_c, kw_c = bench.replay_launch(path, batch=1, device="cuda", compact=True)
        res["fixtures"].append(_compact_case(
            torch, np, fr, "fixture %s shrunk into contact, compact contact"
            % os.path.basename(path), a_c, kw_c, a_d, kw_d))
    a_c, kw_c, _ = bench.big_body_workload(8, n=12, compact=True, device="cuda")
    a_d, kw_d, _ = bench.big_body_workload(8, n=12, device="cuda")
    res["big"] = _compact_case(torch, np, fr, "big-body batch 8 x 12^3 shrunk into contact, "
                               "compact contact", a_c, kw_c, a_d, kw_d)

    gpos, gscale, gtab = _pair_guard_inputs(torch, np, fr, compact=True)
    ref = fr.pair_contact_forces_compact_plain(gpos, gscale, gtab)
    fmax = float(ref.abs().max())
    err = float((fr.pair_contact_forces_compact(gpos, gscale, gtab) - ref).abs().max())
    with mock.patch.object(fr, "PAIR_CULL_MARGIN", -0.5):
        bad = float((fr.pair_contact_forces_compact(gpos, gscale, gtab) - ref).abs().max())
    res["guard"] = dict(phase="compact_guard", max_abs_force=fmax, rel_err=err / fmax,
                        rel_err_margin_minus_half=bad / fmax, tol=K2_REL_TOL,
                        guard_ratio=bad / fmax / K2_REL_TOL)
    emit(res["guard"])
    assert fmax > 0 and err / fmax <= K2_REL_TOL, res["guard"]
    assert bad / fmax >= GUARD_RATIO * K2_REL_TOL, res["guard"]

    counters = dict(fused_rollout="FUSED_ROLLOUT_LAUNCHES",
                    compact="FUSED_ROLLOUT_COMPACT_LAUNCHES",
                    contact="FUSED_ROLLOUT_CONTACT_LAUNCHES")
    for name in counters.values():
        setattr(fr, name, 0)
    recs = [bench.replay(path, "cuda", compact=True) for path in bench.fixture_paths()]
    launches = {k: getattr(fr, name) for k, name in counters.items()}
    for r in recs:
        r.pop("final_state")
        emit(dict(r, phase="compact_replay_path"))
        assert np.isfinite(r["fitness"]) and not r["diverged"], r
    emit(dict(phase="compact_replay_launches", **launches))
    assert launches["compact"] == len(recs) == 4, launches
    res["launches"] = launches
    return res


def _b5_row(b5, fixtures, launches, bound_keys, **extra):
    """The kernels line's row of the compact pass (B5): the launches on the
    replay path with the compact switch, the largest error of K1's compact
    launch against its plain version in the kernels' order over `b5` and
    the `fixtures`' cases, whether every case equalled the dense launch and
    whether the pass's own launch equalled its plain version and the dense
    plain pass bit for bit with the census's tiles, and the time of `b5`'s
    launch beside its bound."""
    cases = [b5] + list(fixtures)
    return dict(name="K1 surface-compacted contact pass (B5)", route="cuda",
                source="evosoro_tpu_torch/ops/csrc/pair_contact.cuh",
                replaces="evosoro_tpu/ops/fused_rollout.py:734",
                launches=launches,
                launches_of="the replay path: the four fixtures with the compact switch",
                **bound_keys(b5),
                max_abs_err=max(r["linmom"] for r in cases),
                momentum_rel_err=max(r["momentum_rel_err"] for r in cases),
                state_bit_equal_to_plain=all(r["state_bit_equal"] for r in cases),
                bit_equal_to_dense=all(r["dense_vs_compact"]["ok"] for r in cases),
                pass_bit_equal_and_census_tiles=all(r["pass"]["ok"] for r in cases),
                pass_ms=b5["pass"]["ms"], pass_plain_ms=b5["pass"]["plain_ms"],
                pass_bound_ms=b5["pass"]["bound_ms"], pass_tiles=b5["pass"]["tiles"],
                err_of=("momentum (kg m/s) of K1 with the compact pass against its plain "
                        "version in the kernels' order, 1 step from lattices shrunk into "
                        "contact: bench 4 x 10^3 on materials_palette and each fixture"),
                ms=b5["ms"], plain_ms=b5["plain_ms"],
                ms_of="K1 launch with the compact pass, bench 4 x 10^3 on materials_palette "
                "shrunk into contact, 25 steps", **extra)


def _compact_registers():
    """Registers and spills (ptxas: [registers, spill stores, spill loads])
    of K1's material and volume instances in this tree's build: with the
    dense pass (the third template argument), with the compact pass (the
    fifth), with neither."""
    from evosoro_tpu_torch.buildcmp import _ptxas_tables
    from evosoro_tpu_torch.ops import build

    table = _ptxas_tables({"this": [str(build._lib_path("fused_rollout"))]})["this"]
    return {k: v for k, v in sorted(table.items()) if k.startswith("fused_rollout_mat")}


def phase_compact_times(torch, np, against=()):
    """The surface-compacted contact pass's times, each beside its bound and
    its launch shape, and with `against` (`--compact --against CHECKOUT
    ...`) in turns with other checkouts' K1 (`buildcmp.in_turns`: each
    checkout, an arm named by its directory, then this, and back), the bits
    of this tree's turns held equal: the bench
    design 4 x 10^3 shrunk into contact, 25 steps; 1024 x 10^3 x 20 with
    contact, compact and dense, on the land palette (the compact launch in
    the material instance, the dense one in the land instance) and on
    `materials_palette` (both in the material instance); each fixture's K1
    launch over its whole stop time, compact and dense; the big-body batch
    32 x 12^3 x 100 with contact (device-memory instances), compact and
    dense; and the material instance without contact on 1024 x 10^3 x 200.
    With `against`, the dense instances whose machine code moved by design
    (features and volume effects: the volume batch, resident; 8 x 10^3,
    shared and forced into the twin) run 25 steps in turns and every arm's
    bits must be equal. Returns the records by workload."""
    from evosoro_tpu_torch import bench, roofline
    from evosoro_tpu_torch.ops import fused_rollout as fr

    arms = None
    if against:
        from evosoro_tpu_torch.buildcmp import in_turns, launchers

        calls = [launchers(c) for c in against]
        arms = {os.path.basename(os.path.normpath(c)): f["other"] for c, f in zip(against, calls)}
        arms["this"] = calls[0]["this"]
    res = {}

    def timed(key, label, a, k, steps, groups=3, reps=2):
        def run():
            return fr.fused_call(*a, num_steps=steps, **k)

        compact = bool(k["flags"].get("collision_compact"))
        n_surf = a[3].shape[-1] if compact else None
        extra = {}
        if arms:
            turns, same = in_turns(arms, lambda: bench.time_call(run, groups, reps), run, 1,
                                   across=("this",))
            ms = min(turns["this"])
            first = next(iter(arms))
            extra = dict(turns=turns, parent_ms=min(turns[first]),
                         this_over_parent=ms / min(turns[first]),
                         bit_equal_across_this=same)
            assert same, (label, turns)
        else:
            ms = bench.time_call(run, groups, reps)
        _, st_out = run()
        ss = k.get("ss_packed")
        rec = dict(phase="compact_time", workload=label, batch=a[0].shape[0], steps=steps,
                   ms=ms, contact=a[3] is not None, compact=compact, surface_voxels=n_surf,
                   **fr.k1_launch_shape(k["grid_shape"], k["flags"], k["scalars"], n_surf),
                   **extra,
                   **roofline.bound(*roofline.launch_work(
                       *a, st_out, flags=k["flags"], grid_shape=k["grid_shape"],
                       scalars=k["scalars"], n_pts=0 if ss is None else (ss.shape[1] - 3) // 2,
                       num_steps=steps)))
        rec["share_of_bound"] = rec["bound_ms"] / ms
        emit(rec)
        res[key] = rec
        return rec

    a, k, _ = bench.packed_workload(4, collision=True, compact=True, device="cuda")
    state = a[0].clone()
    state[:, fr._POS:fr._POS + 3] = _contact_positions(
        torch, np, state[:, fr._POS:fr._POS + 3], 0.5)
    timed("bench4", "bench 4 x 10^3 shrunk into contact, compact, 25 steps",
          (state,) + a[1:], k, 25, 3, 5)
    for mats in (False, True):
        for compact in (True, False):
            a, k, _ = bench.packed_workload(1024, collision=True, compact=compact,
                                            materials=mats, device="cuda")
            timed("bench1024%s_%s" % ("_materials" if mats else "",
                                      "compact" if compact else "dense"),
                  "bench 1024 x 10^3 x 20, contact on, %s%s"
                  % ("compact" if compact else "dense",
                     ", materials_palette" if mats else ""), a, k, 20)
    for i, path in enumerate(bench.fixture_paths()):
        steps = bench.replay_setup(path, "cuda")[4]
        for compact in (True, False):
            a, k = bench.replay_launch(path, batch=1, device="cuda", compact=compact)
            timed("fixture%d_%s" % (i, "compact" if compact else "dense"),
                  "fixture %s, whole stop time, %s" % (
                      os.path.basename(path), "compact" if compact else "dense"),
                  a, k, steps, 2, 1)
    for compact in (True, False):
        a, k, _ = bench.big_body_workload(32, n=12, compact=compact, device="cuda")
        timed("big12_%s" % ("compact" if compact else "dense"),
              "big-body batch 32 x 12^3 x 100, contact on, %s"
              % ("compact" if compact else "dense"), a, k, 100, 2, 1)
        del a
    a, k, _ = bench.packed_workload(1024, materials=True, device="cuda")
    timed("materials_no_contact", "bench 1024 x 10^3 x 200, materials_palette, contact off",
          a, k, 200, 3, 3)
    if arms:
        # the dense instances whose machine code moved by design
        # (`buildcmp.BY_DESIGN`: features and volume effects with the dense
        # pass, resident, shared and twin): every arm's bits equal
        va, vk = bench.volume_workload(device="cuda", features=True)
        ba, bk, _ = bench.packed_workload(8, collision=True, volume=True, device="cuda")
        bk = bench.with_features(bk, ba[2], n_win=4, n_src=1)
        moved = {}
        for label, (a, k), ctx in (("volume batch 16 x 6^3, features, resident", (va, vk), None),
                                   ("bench 8 x 10^3, volume, features", (ba, bk), None),
                                   ("bench 8 x 10^3, volume, features, twin", (ba, bk),
                                    _device_instances(fr))):
            def run(a=a, k=k):
                return fr.fused_call(*a, num_steps=25, **k)

            with ctx or contextlib.nullcontext():
                moved[label] = in_turns(arms, lambda: bench.time_call(run, 2, 2), run, 1)
        res["moved"] = dict(phase="compact_moved_dense_kernels",
                            bit_equal={k: v[1] for k, v in moved.items()},
                            turns={k: v[0] for k, v in moved.items()})
        emit(res["moved"])
        assert all(res["moved"]["bit_equal"].values()), res["moved"]
    ratios = {w: res[w + "_compact"]["ms"] / res[w + "_dense"]["ms"]
              for w in ("bench1024", "bench1024_materials", "big12")}
    res["summary"] = dict(phase="compact_summary", compact_over_dense=ratios,
                          registers=_compact_registers())
    emit(res["summary"])
    return res


def _vol_check(torch, fr, out_k, st_k, out_p, st_p, tol=VOL_TOL):
    """(ok, errs): `_compare` at `tol`, the coupling carry's side means
    (state channels 47-52) and the stats row's dt."""
    ok, errs = _compare(torch, fr, out_k, st_k, out_p, st_p, tol, need_small=False)
    for name, lo, (rtol, atol) in (("ts", fr._TSAVG, VOL_TS), ("cs", fr._CSAVG, VOL_CS)):
        k, p = out_k[:, lo:lo + 3], out_p[:, lo:lo + 3]
        d = (k - p).abs()
        errs[name] = float(d.max())
        errs[name + "_ok"] = bool((d <= atol + rtol * p.abs()).all())
        ok &= errs[name + "_ok"]
    ddt = (st_k[:, fr._S_DT] - st_p[:, fr._S_DT]).abs()
    errs["dt"] = float(ddt.max())
    errs["dt_ok"] = bool((ddt <= VOL_DT_RTOL * st_p[:, fr._S_DT].abs()).all())
    errs["time_ok"] = bool(((st_k[:, fr._S_TIME] - st_p[:, fr._S_TIME]).abs()
                            <= tol["time"][0] * st_p[:, fr._S_TIME].abs()).all())
    errs["pos_ok"] = bool(((out_k[:, :3] - out_p[:, :3]).abs()
                           <= tol["pos"][1] + tol["pos"][0] * out_p[:, :3].abs()).all())
    ok &= errs["dt_ok"]
    errs["carry_bit_equal"] = bool(torch.equal(out_k[:, fr._TSAVG:fr._SOFF],
                                               out_p[:, fr._TSAVG:fr._SOFF]))
    errs["stats_bit_equal"] = bool(torch.equal(st_k, st_p))
    return ok, errs


def _vol_case(torch, fr, label, args, kw, steps, guards=(), extra_check=None,
              time_steps=None, **info):
    """K1's volume instance against its plain version on one input. Each
    guard (name, check, patch) is a plain version with a defect (a function
    of core/step.py replaced) that the kernel's output must fail on the
    named check (`_vol_check`'s "ts_ok"/"cs_ok", "dt_ok"/"time_ok" or
    "pos_ok"); with `time_steps` the kernel and its plain version are timed
    at that many steps beside the bound. Returns the record."""
    from unittest import mock

    from evosoro_tpu_torch import roofline
    from evosoro_tpu_torch.core import step as step_mod

    before = fr.FUSED_ROLLOUT_VOLUME_LAUNCHES
    out_k, st_k = fr.fused_call(*args, num_steps=steps, **kw)
    torch.cuda.synchronize()
    assert fr.FUSED_ROLLOUT_VOLUME_LAUNCHES == before + 1
    out_p, st_p = _plain(fr, *args, num_steps=steps, **kw)
    torch.cuda.synchronize()
    ok, errs = _vol_check(torch, fr, out_k, st_k, out_p, st_p)
    rec = dict(phase="k1_volume_vs_plain", workload=label, batch=args[0].shape[0],
               steps=steps, tol=dict(VOL_TOL, ts=VOL_TS, cs=VOL_CS, dt=VOL_DT_RTOL),
               **info, **errs)
    for name, checks, (fn_name, fn) in guards:
        with mock.patch.object(step_mod, fn_name, fn):
            out_g, st_g = _plain(fr, *args, num_steps=steps, **kw)
        _, g_errs = _vol_check(torch, fr, out_k, st_k, out_g, st_g)
        caught = not all(g_errs[c] for c in checks)
        rec[f"guard_{name}"] = {c: g_errs[c] for c in checks}
        rec[f"guard_{name}_caught"] = caught
        ok &= caught
    if extra_check is not None:
        ok &= extra_check(rec, out_k, st_k, out_p, st_p)
    rec["sha256"] = _digest("k1_volume/%s/steps=%d" % (label, steps), out_k, st_k)
    if time_steps:
        n = time_steps
        rec["timed_steps"] = n
        rec["ms"] = _event_ms(torch, lambda: fr.fused_call(*args, num_steps=n, **kw), 5)
        rec["plain_ms"] = _event_ms(
            torch, lambda: fr.fused_rollout_plain(*args, num_steps=n, **kw), 1, warm=False)
        _, st_n = fr.fused_call(*args, num_steps=n, **kw)
        rec.update(roofline.bound(*roofline.launch_work(
            *args, st_n, kw.get("control_packed"), flags=kw["flags"],
            grid_shape=kw["grid_shape"], scalars=kw["scalars"], num_steps=n)))
    rec["ok"] = ok
    emit(rec)
    assert ok, rec
    return rec


def _vol_guards(torch):
    """The three defects the checks must see, as replacements of the plain
    version's functions: the coupling carry held at (0, L²), the dt kept
    at the carried one, the thermal term dropped."""
    def fixed_carry(bonds, body):
        z = torch.stack([b["strain"] for b in bonds], dim=-4)
        ts = torch.stack([torch.zeros_like(z)] * 2, dim=-5)
        return ts, torch.full_like(ts, body.nominal_size * body.nominal_size)

    return [("carry_fixed", ("ts_ok", "cs_ok"), ("_volume_effects_coupling", fixed_carry)),
            ("constant_dt", ("dt_ok", "time_ok"),
             ("_volume_dt", lambda state, body, sim, bonds, L, dt, dt_reduce=None: dt)),
            ("thermal_dropped", ("pos_ok",),
             ("_thermal_stress", lambda d, state, body, env: 0.0))]


def phase_k1_volume(torch, np, replays=None):
    """Volume effects (B6d): K1's volume instance against its plain version
    on (a) the JAX package's volume parity design, 8 x 4^3 from rest with
    actuation from time 0, 1/25/100 steps, and with 4 control knots; the
    three guards on 25 steps from a quarter of the temperature period; (b) the evaluator's batch of the volume
    experiment (16 x 6^3, a body, pair table and dt per robot, contact on),
    25 and 100 steps, timed at 25; (c) the same with every fitness feature
    (the volume instance's feature instance) and each robot's stop time on
    its own step, 100 steps; (d) the 10^3 cantilever with volume effects
    read with `load_vxa`, 100 steps, its pinned face exact; (e) the bench
    10^3 design with thermal actuation, 8 x 25 steps, and with 8 knots.
    Each checks the coupling carry, the stats dt and the time. Then, each
    with the counts set to 0 just before and read just after: the volume replay of an archived design and of the cantilever
    (with the fitness of the design's replay without volume effects beside
    it: `replays`, `phase_replay`'s records, or a replay made here); two
    generations of the volume experiment; a cold CEM solve with volume
    effects (6 x 128 x 200 steps on the 10^3 bench design, 8 knots), then
    (f) robots 0-7 of its first launch against the plain version, 25 steps;
    and
    the throughput of 1024 x 10^3 x 200 steps in turns with the land and
    material instances. Returns the records by name."""
    import math
    import tempfile

    from evosoro_tpu_torch import bench, roofline
    from evosoro_tpu_torch.control import CEMConfig, cem_optimize_fused
    from evosoro_tpu_torch.core import EnvParams, SimParams
    from evosoro_tpu_torch.ops import fused_rollout as fr

    recs = {}
    # (a)
    args, kw = bench.volume_scenario_workload(8, device="cuda")
    recs["a"] = [_vol_case(torch, fr, "volume design 8 x 4^3", args, kw, steps)
                 for steps in (1, 25, 100)]
    # the guards, from the clock at a quarter of the temperature period, where
    # the thermal term is at its crest (from rest it starts at sin 0)
    stats = args[2].clone()
    stats[:, fr._S_TIME] = 0.25 * stats[:, fr._S_TPER]
    recs["a_guards"] = _vol_case(torch, fr, "volume design 8 x 4^3 from a quarter period",
                                 (args[0], args[1], stats, None), kw, 25, _vol_guards(torch))
    u = _controls(torch, np, 8, 4, args[0].shape[-1], seed=7)
    recs["a_knots"] = _vol_case(torch, fr, "volume design 8 x 4^3, 4 knots", args,
                                dict(kw, control_packed=u, n_knots=4), 25, knots=4)
    # (b), (c)
    args, kw = bench.volume_workload(device="cuda")
    recs["b"] = [_vol_case(torch, fr, "volume evaluator batch 6^3, contact on", args, kw,
                           steps, time_steps=25 if steps == 25 else None)
                 for steps in (25, 100)]
    args, fkw = bench.volume_workload(device="cuda", features=True)
    recs["c"] = _vol_case(torch, fr, "volume evaluator batch 6^3, contact on, features",
                          args, fkw, 100)
    # (d)
    with tempfile.TemporaryDirectory() as tmp:
        args, kw, body = bench.cantilever_workload(os.path.join(tmp, "cantilever.vxa"),
                                                   batch=2, device="cuda", volume=True)
    assert kw["flags"]["volume"] and kw["flags"]["bc"]
    pinned = ((body.dof_fixed == 63) & body.occ).flatten()
    nom = (body.nom_pos + body.external_disp).reshape(-1, 3).T

    def pinned_check(rec, out_k, st_k, out_p, st_p):
        rec["pinned_exact"] = all(torch.equal(o[:, :3][:, :, pinned],
                                              nom[:, pinned].expand(2, -1, -1))
                                  for o in (out_k, out_p))
        return rec["pinned_exact"]

    recs["d"] = _vol_case(torch, fr, "cantilever 10^3 with volume effects (load_vxa)", args,
                          kw, 100, extra_check=pinned_check)
    # (e) the bench 10^3 design with volume effects and thermal actuation, as
    # the throughput's launch runs it (a thread owns several voxels) and with
    # 8 control knots over 25 steps (a knot every 3 steps)
    args, kw, _ = bench.packed_workload(8, device="cuda", volume=True)
    recs["e"] = _vol_case(torch, fr, "bench 8 x 10^3 with volume effects", args, kw, 25)
    u = _controls(torch, np, 8, 8, args[0].shape[-1], seed=11)
    recs["e_knots"] = _vol_case(torch, fr, "bench 8 x 10^3 with volume effects, 8 knots",
                                args, dict(kw, control_packed=u, n_knots=8), 25, knots=8)

    def count(names):
        return {k: getattr(fr, n) for k, n in names.items()}

    counters = dict(fused_rollout="FUSED_ROLLOUT_LAUNCHES",
                    volume="FUSED_ROLLOUT_VOLUME_LAUNCHES",
                    knots="FUSED_ROLLOUT_KNOT_LAUNCHES",
                    contact="FUSED_ROLLOUT_CONTACT_LAUNCHES",
                    bc="FUSED_ROLLOUT_BC_LAUNCHES")

    # the volume replay, beside the replay without volume effects
    for name in counters.values():
        setattr(fr, name, 0)
    vol_recs = bench.volume_replay_workload(device="cuda")
    recs["replay_launches"] = count(counters)
    fixture = os.path.basename(bench.fixture_paths()[0])
    plain_fit = next((r["fitness"] for r in replays or () if r["file"] == fixture
                      and not r["compact"]), None)
    if plain_fit is None:
        r0 = bench.replay(bench.fixture_paths()[0], device="cuda")
        plain_fit = r0["fitness"]
    for r in vol_recs:
        r.pop("final_state")
        r.update(phase="volume_replay", fitness_without_volume=plain_fit
                 if r["file"] == "fixture_volume.vxa" else None, fixture=fixture)
        r["ok"] = (r["volume"] and math.isfinite(r["fitness"]) and not r["diverged"]
                   and r["final_t"] >= 0.999 * r["stop_time"])
        emit(r)
        assert r["ok"], r
    recs["replay"] = vol_recs
    emit(dict(phase="volume_replay_launches", **recs["replay_launches"]))
    # a replay short of its stop time is made again, 1.5 times as long
    assert recs["replay_launches"]["volume"] == recs["replay_launches"]["fused_rollout"] \
        == sum(r["launches"] for r in vol_recs) >= 2, recs["replay_launches"]

    # two generations of the volume experiment
    recs["evolution"] = phase_evolution(torch, ("volume",))["volume"]

    # a cold CEM solve with volume effects
    body, _, env, _ = bench.mpc_workload(device="cuda")
    sim = SimParams(init_cm_time=0.0, volume_effects_enabled=True)
    for name in counters.values():
        setattr(fr, name, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    first = []  # the solve's first launch, kept to hold a slice of it below
    real_call = fr.fused_call

    def keep_first(*a, **k):
        if not first:
            first.append(([t.clone() if t is not None else None for t in a], dict(k)))
        return real_call(*a, **k)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr.fused_call = keep_first
    try:
        _, info = cem_optimize_fused(gen, body, sim, EnvParams(), num_steps=200, num_knots=8,
                                     config=CEMConfig(num_iters=6, pop_size=128),
                                     device="cuda")
    finally:
        fr.fused_call = real_call
    secs = time.perf_counter() - t0
    launches = count(counters)
    trace = [float(c) for c in info["best_cost_trace"]]
    rec = dict(phase="volume_mpc", what="cold cem_optimize_fused solve, volume effects",
               pop_size=128, num_iters=6, steps=200, num_knots=8, seconds=secs,
               best_cost=float(info["best_cost"]), best_cost_trace=trace, **launches)
    rec["ok"] = (launches["volume"] == launches["knots"] == launches["fused_rollout"] == 6
                 and all(math.isfinite(c) for c in trace) and rec["best_cost"] < 1e9)
    emit(rec)
    assert rec["ok"], rec
    recs["mpc_launches"] = launches
    # (f) the solve's own first launch (128 x 10^3, 8 knots over 200 steps),
    # robots 0-7, its first 25 steps
    a, k = first[0]
    n = a[0].shape[0]
    sl = tuple(t[:8].contiguous() if t is not None and t.shape[0] == n else t for t in a)
    k = {key: (v[:8].contiguous() if torch.is_tensor(v) and v.shape[0] == n else v)
         for key, v in k.items() if key != "num_steps"}
    assert k["n_knots"] == 8 and k["flags"]["volume"], k["flags"]
    recs["f"] = _vol_case(torch, fr, "cold CEM solve's first launch, robots 0-7 of %d" % n,
                          sl, k, 25, knots=8)

    # the volume throughput, in turns with the land and material instances
    runs = dict(land=[], materials=[], volume=[])
    for kind in ("land", "materials", "volume", "volume", "materials", "land"):
        runs[kind].append(bench.throughput(batch=1024, steps=200, groups=2, reps=3,
                                           materials=kind == "materials",
                                           volume=kind == "volume"))
    best = {k: min(v, key=lambda r: r["ms"]) for k, v in runs.items()}
    vol = best["volume"]
    args, kw, _ = bench.packed_workload(1024, device="cuda", volume=True)
    _, st_out = fr.fused_call(*args, num_steps=200, **kw)
    b6d = roofline.bound(*roofline.b6d_work(
        args[0], args[1], roofline.volume_clock(args[2], st_out, 200), st_out, kw["flags"]))
    rec = dict(phase="volume_cost", **{f"{k}_ms": [r["ms"] for r in v] for k, v in runs.items()},
               volume_bound_ms=vol["bound_ms"], volume_bound_by=vol["bound_by"],
               volume_share_of_bound=vol["bound_ms"] / vol["ms"],
               volume_voxel_steps_per_s=vol["voxel_steps_per_s"],
               b6d_added_ms=vol["ms"] - best["land"]["ms"],
               b6d_bound_ms=b6d["bound_ms"], b6d_bound_by=b6d["bound_by"],
               b6d_share_of_bound=(b6d["bound_ms"] / (vol["ms"] - best["land"]["ms"])
                                   if vol["ms"] > best["land"]["ms"] else None),
               volume_over_land=vol["ms"] / best["land"]["ms"],
               volume_over_materials=vol["ms"] / best["materials"]["ms"])
    emit(rec)
    recs["cost"] = rec
    return recs


# K1's and B4's material instances in water and with growth: the variants,
# as (model, bench workload arguments, label); and the steps each launch is
# held against its plain version over
MV_STEPS = 15
MAT_VARIANTS = (("face", dict(fluid="face"), "voxel-face drag"),
                ("mesh", dict(fluid="mesh"), "facet drag"),
                ("devo", dict(devo=True), "growth"))


def _linear_sides(torch):
    """A plain version whose facet drag reads the per-side strains of the
    linear fixed point where the stress equalization's belong (the strains
    K1's facet drag read before its material instances), as (module,
    attribute, replacement) for `mock.patch.object`."""
    from evosoro_tpu_torch.core import step as step_mod

    nonlinear = step_mod._nonlinear_stress

    def linear(d, strain, body):
        stress, _, _ = nonlinear(d, strain, body)
        e1, e2 = body.bond_e1[..., d, :, :, :], body.bond_e2[..., d, :, :, :]
        s_sum = e1 + e2
        hom = body.bond_homogeneous[..., d, :, :, :] | (
            torch.abs(e1 - e2) <= 0.0005 * torch.abs(s_sum))
        return (stress, torch.where(hom, strain, 2.0 * step_mod._safe_div(e2, s_sum) * strain),
                torch.where(hom, strain, 2.0 * step_mod._safe_div(e1, s_sum) * strain))

    return step_mod, "_nonlinear_stress", linear


def _sides_slope_guard(torch):
    """The defect B4's facet-drag adjoint on a bilinear palette must see:
    a plain version whose per-side strains carry the linear fixed point's
    derivative (2 E2 / (E1 + E2) of the bond strain on a heterogeneous
    bond) in place of the 3-iteration stress equalization's, their values
    kept, as (name, module, attribute, replacement) for
    `mock.patch.object`."""
    module, attr, linear = _linear_sides(torch)
    nonlinear = getattr(module, attr)

    def linear_slope(d, strain, body):
        stress, sv1, sv2 = nonlinear(d, strain, body)
        _, l1, l2 = linear(d, strain, body)
        return stress, sv1.detach() + l1 - l1.detach(), sv2.detach() + l2 - l2.detach()

    return ("sides_linear_slope", module, attr, linear_slope)


def _matvar_workload(torch, np, model, opts, vol, contact, feat, B=4, n=6):
    """One launch of K1's material instance of a variant: `B` robots of the
    bench design at rest on `materials_palette` with plasticity and the
    clamp at `bench.MATERIALS_MAX_VEL` (and volume effects with `vol`),
    `contact` None, "dense" or
    "compact", the features on with `feat`. Returns (args, kw, label)."""
    from evosoro_tpu_torch import bench

    args, kw, _ = bench.packed_workload(B, n=n, collision=contact is not None,
                                        compact=contact == "compact", device="cuda",
                                        materials=True, volume=vol, **opts)
    # the clamp at the materials batch's limit, so that it acts
    kw = dict(kw, scalars=dict(kw["scalars"], max_vel_limit=bench.MATERIALS_MAX_VEL))
    if feat:
        kw = bench.with_features(kw, args[2], n_win=4, n_src=1)
    X = kw["grid_shape"][0]
    label = "%s, %d x %d^3 on materials_palette%s, contact %s%s" % (
        model, B, X, ", volume effects" if vol else "", contact or "off",
        ", features" if feat else "")
    return args, kw, label


def phase_k1_mat_variants(torch, np):
    """K1's material and volume instances in water and with growth
    (csrc/fused_rollout_matvar.cuh) against the plain version. In each
    variant (`MAT_VARIANTS`: voxel-face drag, facet drag, growth) the bench
    design at rest (4 x 6^3, 7^3 with the fluids' shell) on
    `materials_palette` (bilinear muscle, MDL_DATA tissue) with plasticity
    and the max-velocity clamp, without and with volume effects, without
    contact, with the dense pass and with the compact one, without and with
    the features: MV_STEPS steps against the plain version (the material
    gates of the land instance, `_strictest`; volume effects at
    `_vol_check`'s), and the device-memory twin (forced) bit-equal to the
    shared instance. The compact launch equals the dense one bit for bit on
    the design's lattice shrunk into contact, over 1 and 25 steps. Guards
    without contact: each material branch's bit off (nonlinear and
    MDL_DATA, plasticity, the clamp) must fail the gates over 100 steps;
    under volume effects the plain version without the thermal term
    (`_vol_guards`), over 50; with the facet drag at STRONG_DRAG over 50
    steps the kernel must pass the gates and
    the no-drag launch fail them, and both the no-drag launch and a plain
    version whose corners read the linear fixed point's per-side strains
    (which differ from the material ones only past yield on heterogeneous
    bonds) must part from the plain version by GUARD_RATIO times the
    kernel's own momentum error. Returns the records by variant."""
    from unittest import mock

    from evosoro_tpu_torch import roofline
    from evosoro_tpu_torch.ops import fused_rollout as fr

    tol = _strictest("nonlinear", "plasticity", "max_vel")
    soff = slice(fr._SOFF, fr._SOFF + 3)
    out = {}
    for model, opts, what in MAT_VARIANTS:
        recs = []
        m0 = (fr.FUSED_ROLLOUT_MATERIAL_LAUNCHES, fr.FUSED_ROLLOUT_VOLUME_LAUNCHES,
              fr.FUSED_ROLLOUT_COMPACT_LAUNCHES)
        v0 = dict(face=fr.FUSED_ROLLOUT_FLUID_LAUNCHES, mesh=fr.FUSED_ROLLOUT_MESH_LAUNCHES,
                  devo=fr.FUSED_ROLLOUT_DEVO_LAUNCHES)[model]
        for vol in (False, True):
            for contact in (None, "dense", "compact"):
                for feat in (False, True):
                    args, kw, label = _matvar_workload(torch, np, model, opts, vol, contact,
                                                       feat)
                    assert fr.k1_launch_shape(kw["grid_shape"], kw["flags"], kw["scalars"],
                                              args[3].shape[-1] if contact == "compact"
                                              else None)["resident"] is False
                    out_k, st_k = fr.fused_call(*args, num_steps=MV_STEPS, **kw)
                    out_p, st_p = _plain(fr, *args, num_steps=MV_STEPS, **kw)
                    torch.cuda.synchronize()
                    if vol:
                        ok, errs = _vol_check(torch, fr, out_k, st_k, out_p, st_p)
                    else:
                        ok, errs = _compare(torch, fr, out_k, st_k, out_p, st_p, tol)
                        d = (out_k[:, soff] - out_p[:, soff]).abs()
                        errs["strain_offset_err"] = float(d.max())
                        ok &= bool((d <= 1e-7 + SOFF_RTOL * out_p[:, soff].abs()).all())
                    with _device_instances(fr):
                        out_g, st_g = fr.fused_call(*args, num_steps=MV_STEPS, **kw)
                    torch.cuda.synchronize()
                    twin = bool(torch.equal(out_g, out_k) and torch.equal(st_g, st_k))
                    rec = dict(phase="k1_mat_variants_vs_plain", model=model, workload=label,
                               steps=MV_STEPS, tol=dict(VOL_TOL, ts=VOL_TS, cs=VOL_CS)
                               if vol else tol, twin_bit_equal=twin, **errs)
                    rec["sha256"] = _digest("k1_mat_variants/" + label, out_k, st_k)
                    if contact == "dense" and not (vol or feat):
                        n_pts = (kw["ss_packed"].shape[1] - 3) // 2
                        rec["ms"] = _event_ms(
                            torch, lambda: fr.fused_call(*args, num_steps=MV_STEPS, **kw), 5)
                        rec["plain_ms"] = _event_ms(torch, lambda: fr.fused_rollout_plain(
                            *args, num_steps=MV_STEPS, **kw), 1, warm=False)
                        rec.update(roofline.bound(*roofline.launch_work(
                            *args, st_k, flags=kw["flags"], grid_shape=kw["grid_shape"],
                            scalars=kw["scalars"], n_pts=n_pts)))
                    if contact == "compact":
                        # on the lattice shrunk into contact: the compact launch
                        # equals the dense one, and contact moves the state
                        a_d, kw_d, _ = _matvar_workload(torch, np, model, opts, vol, "dense",
                                                        feat)
                        state = args[0].clone()
                        state[:, fr._POS:fr._POS + 3] = _contact_positions(
                            torch, np, state[:, fr._POS:fr._POS + 3], 0.5)
                        equal, moved = {}, 0.0
                        for steps in (1, 25):
                            o_c, s_c = fr.fused_call(state, *args[1:], num_steps=steps, **kw)
                            o_d, s_d = fr.fused_call(state, *a_d[1:], num_steps=steps, **kw_d)
                            equal[steps] = bool(torch.equal(o_c, o_d) and torch.equal(s_c, s_d))
                        no_kw = dict(kw, flags=dict(kw["flags"], collision=False,
                                                    collision_compact=False))
                        o_n, _ = fr.fused_call(state, *args[1:3], None, num_steps=1, **no_kw)
                        moved = float((o_n[:, fr._LIN:fr._LIN + 3]
                                       - o_c[:, fr._LIN:fr._LIN + 3]).abs().max())
                        rec.update(compact_bit_equal_dense=equal, contact_moves_linmom=moved)
                        ok &= all(equal.values()) and moved > 0
                    rec["ok"] = bool(ok and twin)
                    emit(rec)
                    assert rec["ok"], rec
                    recs.append(rec)
        # guards without contact: the material bits at 100 steps; the
        # thermal term, whose fluid branch is new, at 50 (the other volume
        # guards hold the code the land instance shares, phase_k1_volume)
        for vol in (False, True):
            args, kw, label = _matvar_workload(torch, np, model, opts, vol, None, False)
            if vol:
                recs.append(_vol_case(torch, fr, label + ", guards", args, kw, 50,
                                      guards=[g for g in _vol_guards(torch)
                                              if g[0] == "thermal_dropped"], model=model))
                continue
            off = lambda **f: dict(kw, flags=dict(kw["flags"], **f))  # noqa: E731
            recs.append(_mat_case(
                torch, fr, label + ", guards", args, kw, 100, tol,
                [("nonlinear", dict(off(nonlinear=False, mdl_data=False), ss_packed=None)),
                 ("plasticity", off(plasticity=False)), ("max_vel", off(max_vel=False))],
                model=model))
            if model == "mesh":
                strong = _with_drag(args, STRONG_DRAG)
                out_k, st_k = fr.fused_call(*strong, num_steps=50, **kw)
                out_p, st_p = _plain(fr, *strong, num_steps=50, **kw)
                out_0, st_0 = fr.fused_call(*_with_drag(strong, 0.0), num_steps=50, **kw)
                module, attr, fn = _linear_sides(torch)
                with mock.patch.object(module, attr, fn):
                    out_l, _ = _plain(fr, *strong, num_steps=50, **kw)
                torch.cuda.synchronize()
                ok, errs = _compare(torch, fr, out_k, st_k, out_p, st_p, tol, False)
                no_drag_passes, _ = _compare(torch, fr, out_0, st_0, out_p, st_p, tol, False)
                lin = slice(fr._LIN, fr._LIN + 3)
                err = float((out_k[:, lin] - out_p[:, lin]).abs().max())
                rec = dict(phase="k1_mat_variants_mesh_guards", workload=label,
                           drag=STRONG_DRAG, steps=50, kernel_vs_plain_ok=ok,
                           kernel_linmom_err=err, kernel_pos_err=errs["pos"],
                           no_drag_effect=float((out_0[:, lin] - out_p[:, lin]).abs().max()),
                           no_drag_passes=no_drag_passes,
                           linear_sides_effect=float((out_l[:, lin] - out_p[:, lin]).abs().max()),
                           linear_sides_pos_effect=float(
                               (out_l[:, :3] - out_p[:, :3]).abs().max()))
                rec["ok"] = bool(ok and not no_drag_passes
                                 and rec["no_drag_effect"] >= GUARD_RATIO * max(err, 1e-12)
                                 and rec["linear_sides_effect"]
                                 >= GUARD_RATIO * max(err, 1e-12))
                emit(rec)
                assert rec["ok"], rec
                recs.append(rec)
        launches = dict(
            material=fr.FUSED_ROLLOUT_MATERIAL_LAUNCHES - m0[0],
            volume=fr.FUSED_ROLLOUT_VOLUME_LAUNCHES - m0[1],
            compact=fr.FUSED_ROLLOUT_COMPACT_LAUNCHES - m0[2],
            variant=dict(face=fr.FUSED_ROLLOUT_FLUID_LAUNCHES, mesh=fr.FUSED_ROLLOUT_MESH_LAUNCHES,
                         devo=fr.FUSED_ROLLOUT_DEVO_LAUNCHES)[model] - v0)
        emit(dict(phase="k1_mat_variants_launches", model=model, **launches))
        assert launches["material"] > 0 and launches["volume"] > 0 and launches["compact"] > 0
        assert launches["variant"] >= launches["material"], launches
        out[model] = recs
    return out


def phase_b4_mat_variants(torch, np):
    """B4's material instance in water and with growth
    (csrc/fused_rollout_bwd_matvar.cu) against `fused_bwd_plain` on the SQP
    solver's launch of `bench.sqp_workload(materials=True, ...)` in each
    variant (8 x 10^3 in its 11^3 shell in water, 8 x 5x5x4 with growth, on
    the bilinear palette with the clamp, 25 steps of a 200-step clock, 8
    knots): from rest; 75 steps in (timed), with the material instance's
    guards (`_material_guards`), where the clamp acts; and 75 steps in
    where the variant's guards weigh (`_b4_guards`: in water at STRONG_DRAG
    from perturbed momenta, with growth under tight clamp bounds, as
    `phase_b4_variants`; with the facet drag also the per-side strains'
    slope of the linear fixed point, `_sides_slope_guard`, on bonds past
    yield); each also with a launch one step short and the neighbouring
    knot as guards, and each record with the plain version's bond-steps
    past yield and clamped voxel-steps. B4's recomputed end state equals
    K1's launch bit for bit, and the device-memory twin (forced) the shared
    instance. K1's launches of the same solve are held against the plain
    version at the material gates (`_strictest`; with the facet drag
    `MESH_TOL`'s other channels): the 75 steps from rest and the 25-step
    segment at seg_base 75, which with its knots zeroed must fail the
    comparison. Returns ({model: B4 records}, {model: K1 records})."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.core.rollout import init_state
    from evosoro_tpu_torch.ops import fused_rollout as fr

    B, K, S, total = 8, 8, 25, 200
    out, k1 = {}, {}
    for model, opts, what in MAT_VARIANTS:
        body, sim, env, dt = bench.sqp_workload(device="cuda", materials=True, **opts)
        body_packed = fr.pack_body(body)
        state0 = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
        stats0 = fr.make_stats(body, B, dt, sim, env)
        kw = dict(num_steps=S, grid_shape=tuple(body.occ.shape),
                  scalars=fr.kernel_scalars(body.nominal_size, sim, env),
                  flags=fr.launch_flags(body, sim, env, collision=False, segmented=True),
                  n_knots=K, total_steps=total)
        assert kw["flags"]["nonlinear"] and kw["flags"]["max_vel"], kw["flags"]
        V = body.occ.numel()
        ctrl = _controls(torch, np, B, K, V, seed=43)
        label = "SQP launch %d x %s, %s, bilinear palette, clamp" % (
            B, "x".join(map(str, kw["grid_shape"])), what)
        k1_kw = {k: v for k, v in kw.items() if k != "num_steps"}
        k1_kw["control_packed"] = ctrl
        tol = _strictest("nonlinear", "max_vel")
        k1_opts = dict(phase="k1_sqp_launch_vs_plain", model="materials " + model, knots=K,
                       tol=dict(MESH_TOL, **tol) if model == "mesh" else tol)
        k1[model] = _k1_cases(torch, fr, label + ", from rest",
                              (state0, body_packed, stats0, None), dict(k1_kw, seg_base=0),
                              B, False, (75,), **k1_opts)
        st75, ss75 = fr.fused_call(state0, body_packed, stats0, None, control_packed=ctrl,
                                   seg_base=0, **dict(kw, num_steps=75))
        seg = (st75, body_packed, ss75, None)
        k1[model] += _k1_cases(torch, fr, label + ", 75 steps in", seg,
                               dict(k1_kw, seg_base=75), B, False, (S,), **k1_opts)
        # guard: the segment with its knots zeroed must fail against the plain
        # version with them
        out_z, st_z = fr.fused_call(*seg, num_steps=S, **dict(
            k1_kw, seg_base=75, control_packed=torch.zeros_like(ctrl)))
        out_p, st_p = _plain(fr, *seg, num_steps=S, **dict(k1_kw, seg_base=75))
        passes, errs = _compare(torch, fr, out_z, st_z, out_p, st_p, k1_opts["tol"])
        rec = dict(phase="k1_sqp_launch_guard", workload=label + ", 75 steps in, knots zeroed",
                   passes=passes, pos_err=errs["pos"], ok=not passes)
        emit(rec)
        assert rec["ok"], rec
        gs, gss = st75.clone(), ss75.clone()
        guards = _b4_guards(torch, model)
        if model == "devo":
            gss[:, fr._S_MINTF] = 0.9995
            gss[:, fr._S_GAMP] = 5e-4
            where_v = "75 steps in, clamp bounds 0.9995 L and 1.0005 L"
        else:
            gss[:, fr._S_DRAGC] = STRONG_DRAG
            rng = np.random.default_rng(7)
            occ = (body_packed[:, fr._B_OCC] > 0.5).float()
            for a, b in ((fr._LIN, fr._LIN + 3), (fr._ANG, fr._ANG + 3)):
                noise = torch.as_tensor(rng.standard_normal((B, 3, V)).astype(np.float32),
                                        device="cuda")
                gs[:, a:b] += 3 * noise * gs[:, a:b].abs().max() * occ[:, None]
            where_v = "75 steps in, drag %g, momenta perturbed" % STRONG_DRAG
            if model == "mesh":
                guards = guards + [_sides_slope_guard(torch)]
        recs = []
        for where, st, ss, base, case_guards, seed in (
                ("from rest", state0, stats0, 0, (), 9),
                ("75 steps in", st75, ss75, 75, _material_guards(torch), 10),
                (where_v, gs.contiguous(), gss.contiguous(), 75, guards, 11)):
            yielded, clamped = _material_branches(torch, fr, st, body_packed, ss, ctrl, base,
                                                  kw)
            m0 = fr.FUSED_BWD_MATERIAL_LAUNCHES
            rec = _b4_case(torch, np, fr, "%s, %s" % (label, where), st, body_packed, ss, ctrl,
                           base, kw, seed=seed, timed=where == "75 steps in",
                           guards=case_guards)
            assert fr.FUSED_BWD_MATERIAL_LAUNCHES > m0
            rec.update(model=model, bond_steps_past_yield=yielded, voxel_steps_clamped=clamped)
            if case_guards is guards and model == "mesh":
                # the slope guard weighs only past yield
                assert yielded > 0, rec
            if where == "75 steps in":
                # the clamp's guard weighs where it acts
                assert clamped > 0, rec
                cot = torch.as_tensor(np.random.default_rng(seed).standard_normal(
                    st.shape).astype(np.float32), device="cuda")
                cot[:, fr._TSAVG:] = 0.0
                got, tape = _b4_tape(torch, fr, st, body_packed, ss, ctrl, base, cot, **kw)
                end, _ = fr.fused_call(st, body_packed, ss, None, control_packed=ctrl,
                                       seg_base=base, **kw)
                with _device_instances(fr):
                    twin = fr.fused_bwd_call(st, body_packed, ss, ctrl, base, cot, **kw)
                torch.cuda.synchronize()
                rec.update(recompute_bit_equal_k1=torch.equal(tape[:, S, :fr._TSAVG],
                                                              end[:, :fr._TSAVG]),
                           twin_bit_equal=all(torch.equal(a, b) for a, b in zip(twin, got)))
                assert rec["recompute_bit_equal_k1"] and rec["twin_bit_equal"], rec
            emit(dict(phase="b4_mat_variants", model=model, workload=rec["workload"],
                      **{k: rec[k] for k in ("bond_steps_past_yield", "voxel_steps_clamped",
                                             "recompute_bit_equal_k1", "twin_bit_equal")
                         if k in rec}))
            recs.append(rec)
        out[model] = recs
    return out, k1


def phase_mat_variants_times(torch, np):
    """K1's material instances in water and with growth on the workloads
    of PERF.md section 6, each beside its plain version at the same batch
    and grid (over 2 steps: the plain version runs ~10^4 x slower) and its
    bound (`roofline.launch_work`): 1024 x 11^3 x 200 without contact on
    `materials_palette` with the voxel-face and the facet drag, and the same
    with volume effects; 1024 x 10^3 x 200 with growth, and with volume
    effects; 1024 x 11^3 x 20 in water with contact, dense and compact
    (the bench design, at rest). Returns the records."""
    from evosoro_tpu_torch import bench, roofline
    from evosoro_tpu_torch.ops import fused_rollout as fr

    recs = []
    cases = [(m, o, w, vol, None, 200) for vol in (False, True)
             for m, o, w in MAT_VARIANTS]
    cases += [(m, o, w, False, c, 20) for m, o, w in MAT_VARIANTS[:2]
              for c in ("dense", "compact")]
    for model, opts, what, vol, contact, steps in cases:
        args, kw, _ = bench.packed_workload(1024, n=10, collision=contact is not None,
                                            compact=contact == "compact", device="cuda",
                                            materials=True, volume=vol, **opts)
        ms = [_event_ms(torch, lambda: fr.fused_call(*args, num_steps=steps, **kw), 3)
              for _ in range(2)]
        plain_ms = _event_ms(torch, lambda: fr.fused_rollout_plain(
            *args, num_steps=2, **kw), 1, warm=False)
        _, st_n = fr.fused_call(*args, num_steps=steps, **kw)
        ss = kw.get("ss_packed")
        bound = roofline.bound(*roofline.launch_work(
            *args, st_n, flags=kw["flags"], grid_shape=kw["grid_shape"],
            scalars=kw["scalars"], n_pts=0 if ss is None else (ss.shape[1] - 3) // 2,
            num_steps=steps))
        rec = dict(phase="mat_variants_times", model=model,
                   workload="1024 x %s x %d, %s on materials_palette%s, contact %s" % (
                       "x".join(map(str, kw["grid_shape"])), steps, what,
                       ", volume effects" if vol else "", contact or "off"),
                   ms=min(ms), ms_all=ms, plain_ms=plain_ms, plain_steps=2,
                   shape=fr.k1_launch_shape(kw["grid_shape"], kw["flags"], kw["scalars"],
                                            args[3].shape[-1] if contact == "compact"
                                            else None),
                   **bound)
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        emit(rec)
        recs.append(rec)
    return recs


def phase_sqp_mat_variants(torch, b4_mv):
    """The gradient-MPC path on the bilinear palette with the max-velocity
    clamp in water and with growth: `bench.sqp(materials=True, ...)` in
    each variant (a cold solve and three re-plans), every launch counter
    set to 0 just before and read just after: its 4 x 72 K1 launches are
    the material instance's of the variant, its 4 x 32 B4 launches B4's.
    Returns the launches by variant."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.ops import fused_rollout as fr

    counters = dict(fused_rollout="FUSED_ROLLOUT_LAUNCHES",
                    fused_rollout_with_knots="FUSED_ROLLOUT_KNOT_LAUNCHES",
                    fused_rollout_material="FUSED_ROLLOUT_MATERIAL_LAUNCHES",
                    fused_rollout_fluid="FUSED_ROLLOUT_FLUID_LAUNCHES",
                    fused_rollout_mesh="FUSED_ROLLOUT_MESH_LAUNCHES",
                    fused_rollout_devo="FUSED_ROLLOUT_DEVO_LAUNCHES",
                    fused_bwd="FUSED_BWD_LAUNCHES",
                    fused_bwd_material="FUSED_BWD_MATERIAL_LAUNCHES",
                    fused_bwd_fluid="FUSED_BWD_FLUID_LAUNCHES",
                    fused_bwd_mesh="FUSED_BWD_MESH_LAUNCHES",
                    fused_bwd_devo="FUSED_BWD_DEVO_LAUNCHES")
    out = {}
    for model, opts, what in MAT_VARIANTS:
        for name in counters.values():
            setattr(fr, name, 0)
        rec = bench.sqp(device="cuda", materials=True, **opts)
        launches = {k: getattr(fr, name) for k, name in counters.items()}
        timed = next(r for r in b4_mv[model] if "ms" in r)
        rec.update(b4_ms_per_launch=timed["ms"], k1_ms_per_launch=timed["k1_ms"],
                   b4_share=rec["b4_launches_per_solve"] * timed["ms"] / rec["ms_per_solve"],
                   k1_share=rec["k1_launches_per_solve"] * timed["k1_ms"]
                   / rec["ms_per_solve"])
        emit(dict(phase="sqp", what="FusedSQPSolver: cold solve and re-plans, bilinear "
                  "palette with the max-velocity clamp, %s" % what, model=model, **rec))
        emit(dict(phase="sqp_launches", model="materials " + model, **launches))
        _sqp_checks(rec, launches)
        key = dict(face="fluid", mesh="mesh", devo="devo")[model]
        assert launches["fused_rollout_material"] == launches["fused_rollout_" + key] \
            == 4 * 72, launches
        assert launches["fused_bwd_material"] == launches["fused_bwd_" + key] == 4 * 32, launches
        out[model] = dict(launches, ms_per_replan=rec["ms_per_solve"])
    return out


def _mat_variant_rows(k1_mv, k1_sqp_mv, b4_mv, sqp_mv, evo_mv, times, bound_keys):
    """The kernels line's rows of K1's and B4's material instances in water
    and with growth."""
    k1_recs = [r for recs in k1_mv.values() for r in recs
               if r["phase"] == "k1_mat_variants_vs_plain"]
    k1_sqp_recs = [r for recs in k1_sqp_mv.values() for r in recs]
    timed = next(r for r in k1_mv["mesh"] if "ms" in r)
    k1_sqp = sum(v["fused_rollout_material"] for v in sqp_mv.values())
    k1_evo = evo_mv["fused_rollout_material"]
    b4_recs = [r for recs in b4_mv.values() for r in recs]
    b4_timed = next(r for r in b4_mv["mesh"] if "ms" in r)
    k1_row = dict(
        name="fused_rollout_matvar (K1 material and volume instances in water and with growth)",
        route="cuda", source="evosoro_tpu_torch/ops/csrc/fused_rollout_matvar.cuh",
        replaces="evosoro_tpu/ops/fused_rollout.py:777",
        launches=k1_evo + k1_sqp, launches_swimming_materials=k1_evo,
        launches_sqp=k1_sqp,
        launches_of="two generations of the swimming-materials experiment; bench.sqp on "
        "the bilinear palette with the clamp with the facet drag, the voxel-face drag and "
        "growth (a cold solve and 3 re-plans each)",
        **bound_keys(timed),
        max_abs_err=max(r["pos"] for r in k1_recs + k1_sqp_recs),
        sqp_launch_state_bit_equal=all(r["state_bit_equal"] for r in k1_sqp_recs),
        twins_bit_equal=all(r["twin_bit_equal"] for r in k1_recs),
        compact_bit_equal_dense=all(all(r["compact_bit_equal_dense"].values())
                                    for r in k1_recs if "compact_bit_equal_dense" in r),
        err_of="pos (m) against the plain version: each variant (face, facet, growth) on "
        "materials_palette with plasticity and the clamp, 4 x 6^3 (7^3 in water), without "
        "and with volume effects, contact off, dense and compact, without and with the "
        "features, %d steps; the fused SQP solve's segmented launches on the bilinear "
        "palette with the clamp in each variant (8 x 11^3, 8 x 5x5x4), 8 knots, 75 steps "
        "from rest and 25 steps at seg_base 75" % MV_STEPS,
        ms=timed["ms"], plain_ms=timed["plain_ms"],
        ms_of=timed["workload"] + ", %d steps" % MV_STEPS)
    if times:
        k1_row["times_1024"] = {r["workload"]: dict(ms=r["ms"], plain_ms_2_steps=r["plain_ms"],
                                                   bound_ms=r["bound_ms"])
                                for r in times}
    b4_row = dict(
        name="fused_rollout_bwd_matvar (B4 material instance in water and with growth)",
        route="cuda", source="evosoro_tpu_torch/ops/csrc/fused_rollout_bwd_matvar.cu",
        replaces="evosoro_tpu/ops/fused_rollout.py:2745",
        launches=sum(v["fused_bwd_material"] for v in sqp_mv.values()),
        launches_of="bench.sqp(materials=True) with the facet drag, the voxel-face drag and "
        "growth: a cold solve and 3 re-plans each",
        **bound_keys(b4_timed),
        max_abs_err=max(r["max_abs_err"] for r in b4_recs),
        worst_rel_err=max(r["worst_rel_err"] for r in b4_recs),
        ms=b4_timed["ms"], plain_ms=b4_timed["plain_ms"],
        launch_shape=b4_timed["launch_shape"], ms_of=b4_timed["workload"],
        ms_by_variant={m: next(r for r in v if "ms" in r)["ms"] for m, v in b4_mv.items()},
        ms_per_replan={m: v["ms_per_replan"] for m, v in sqp_mv.items()},
        err_of="cotangent of the controls, against autograd through the plain version: the "
        "SQP launch 8 x 25 steps, 8 knots, on the bilinear palette with the clamp, from rest, "
        "75 steps in, and there at STRONG_DRAG or tight clamp bounds, in each variant")
    return [k1_row, b4_row]


def phase_replay(torch):
    """The replay path as a user drives it: `load_vxa` -> `fused_rollout`
    -> `locomotion_fitness`, the four fixtures (dense and with the compact
    switch) and the hand-written cantilever (with the max-velocity clamp,
    and in equilibrium mode). Every count is set to 0 just before and read
    just after; each material branch must have launched. Returns the counts
    and the records (`bench.replay`'s, less the final state)."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.ops import fused_rollout as fr

    counters = dict(fused_rollout="FUSED_ROLLOUT_LAUNCHES",
                    material="FUSED_ROLLOUT_MATERIAL_LAUNCHES",
                    nonlinear="FUSED_ROLLOUT_NONLINEAR_LAUNCHES",
                    solver="FUSED_ROLLOUT_SOLVER_LAUNCHES",
                    bc="FUSED_ROLLOUT_BC_LAUNCHES",
                    compact="FUSED_ROLLOUT_COMPACT_LAUNCHES",
                    contact="FUSED_ROLLOUT_CONTACT_LAUNCHES")
    for name in counters.values():
        setattr(fr, name, 0)
    import math

    recs = bench.replay_workload(device="cuda")
    launches = {k: getattr(fr, name) for k, name in counters.items()}
    for r in recs:
        r.pop("final_state")
        emit(dict(r, phase="replay_path"))
        assert math.isfinite(r["fitness"]) and not r["diverged"], r
    emit(dict(phase="replay_launches", **launches))
    assert launches["fused_rollout"] == len(recs) == 10, launches
    assert launches["compact"] == 4 and launches["bc"] == 2 and launches["solver"] == 2, launches
    return launches, recs


def _controls(torch, np, batch, knots, voxels, seed):
    """Controls (B, K, V), uniform in ±0.05 and different for every robot."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.05, 0.05, size=(batch, knots, voxels)).astype(np.float32)
    return torch.as_tensor(u, device="cuda")


def _knot_workloads(collisions=(False, True)):
    """(label, args, kw, collision) of the bench 10^3 design (8 robots, one
    shared body) and of the evaluator's batch (16 x 6^3, a body per robot)."""
    from evosoro_tpu_torch.bench import evaluator_workload, packed_workload

    for coll in collisions:
        args, kw, _ = packed_workload(8, collision=coll, device="cuda")
        yield "bench 10^3, shared body", args, kw, coll
        args, kw = evaluator_workload(collision=coll, device="cuda")
        yield "evaluator batch 6^3, a body per robot", args, kw, coll


def phase_k1_knots(torch, np, steps_list=(1, 25, 100)):
    """K1's control-knot channel against the plain version: K in {1, 4},
    at `steps_list` (the full run takes 1 and 25 steps: at 25 the 4 knots
    change every 6 steps; `--land` keeps 100 too), contact off and on, on
    both workloads. Then the guard in the data: with only robot 1's knots
    non-zero every other robot must come out of the launch as it does with
    no knots at all, bit for bit."""
    from evosoro_tpu_torch.ops import fused_rollout as fr

    recs = []
    for label, args, kw, coll in _knot_workloads():
        B, _, V = args[0].shape
        for K in (1, 4):
            u = _controls(torch, np, B, K, V, seed=K)
            recs += _k1_cases(torch, fr, label, args,
                              dict(kw, control_packed=u, n_knots=K), B, coll,
                              steps_list, phase="k1_knots_vs_plain", knots=K)
        u = _controls(torch, np, B, 4, V, seed=9)
        u[torch.arange(B, device="cuda") != 1] = 0.0
        one, one_st = fr.fused_call(*args, num_steps=25, control_packed=u,
                                    n_knots=4, **kw)
        none, none_st = fr.fused_call(*args, num_steps=25, **kw)
        others = torch.arange(B, device="cuda") != 1
        rec = dict(phase="k1_knots_one_robot", workload=label, collision=coll,
                   others_equal=bool(torch.equal(one[others], none[others])
                                     and torch.equal(one_st[others], none_st[others])),
                   robot_1_moved=float((one[1] - none[1]).abs().max()))
        emit(rec)
        assert rec["others_equal"] and rec["robot_1_moved"] > 0, rec
    return recs


def phase_k1_segmented(torch, np):
    """Three segmented K1 launches of 8 steps (seg_base 0, 8, 16 of 24 steps,
    4 knots) against one 24-step launch, bit for bit, and against the plain
    version at K1's tolerances."""
    from evosoro_tpu_torch.ops import fused_rollout as fr

    for label, args, kw, coll in _knot_workloads():
        state, body, stats, table = args
        B, _, V = state.shape
        ckw = dict(kw, control_packed=_controls(torch, np, B, 4, V, seed=3), n_knots=4)
        whole, whole_st = fr.fused_call(*args, num_steps=24, **ckw)
        seg_kw = dict(ckw, flags=dict(kw["flags"], segmented=True), total_steps=24)
        before = fr.FUSED_ROLLOUT_KNOT_LAUNCHES
        st, ss = state, stats
        for base in (0, 8, 16):
            st, ss = fr.fused_call(st, body, ss, table, num_steps=8,
                                   seg_base=base, **seg_kw)
        torch.cuda.synchronize()
        assert fr.FUSED_ROLLOUT_KNOT_LAUNCHES == before + 3
        st_p, ss_p = state, stats
        for base in (0, 8, 16):
            st_p, ss_p = _plain(fr, st_p, body, ss_p, table, num_steps=8, seg_base=base,
                                **seg_kw)
        ok, errs = _compare(torch, fr, st, ss, st_p, ss_p)
        rec = dict(phase="k1_segmented", workload=label, collision=coll,
                   chain_equals_whole=bool(torch.equal(st, whole)
                                           and torch.equal(ss, whole_st)),
                   max_abs_diff=float((st - whole).abs().max()),
                   vs_plain=errs, ok=ok,
                   sha256=_digest(f"k1_segmented/{label}/coll={coll}", st, ss))
        emit(rec)
        assert rec["chain_equals_whole"] and ok, rec


def phase_fp32_peak(torch):
    """fma_peak against its plain version, then the card's measured FP32
    multiply-add rate through `roofline.measure_fp32_peak`, with the
    launches of that measurement counted."""
    from evosoro_tpu_torch import roofline

    n = torch.cuda.get_device_properties(0).multi_processor_count * 2048
    x = torch.rand(n, device="cuda") + 0.5
    iters = FMA_CHECK_ITERS
    before = roofline.FMA_PEAK_LAUNCHES
    out = roofline.fma_chains(x, iters)
    torch.cuda.synchronize()
    assert roofline.FMA_PEAK_LAUNCHES == before + 1
    ref = roofline.fma_chains_plain(x, iters)

    def rel_to_ref(t):
        return float(((t - ref).abs() / ref.abs()).max())

    err = float((out - ref).abs().max())
    rel = rel_to_ref(out)
    check = dict(
        iters=iters, bit_equal_share=float((out == ref).float().mean()),
        # what the check can see: the whole loop's effect, and 16 steps fewer
        loop_effect_rel=rel_to_ref(roofline.fma_chains(x, 0)),
        rel_err_16_steps_short=rel_to_ref(roofline.fma_chains(x, iters - 16)))
    # the row of the kernels line: both timed on one input at 512 iterations
    ms = _event_ms(torch, lambda: roofline.fma_chains(x, 512), 20)
    plain_ms = _event_ms(torch, lambda: roofline.fma_chains_plain(x, 512), 1)
    row = dict(max_abs_err=err, rel_err=rel, tol=FMA_RTOL, **check, ms=ms,
               plain_ms=plain_ms,
               ms_of="%d threads x 16 chains x 512 steps" % n,
               **roofline.bound(*roofline.fma_work(n, 512)))
    roofline.FMA_PEAK_LAUNCHES = 0
    peak = roofline.measure_fp32_peak()
    launches = roofline.FMA_PEAK_LAUNCHES
    rec = dict(phase="fp32_peak", threads=n, **row, peak=peak,
               published_flops_per_s=roofline.H100_FP32_FLOPS,
               share_of_published=peak["flops_per_s"] / roofline.H100_FP32_FLOPS,
               launches=launches)
    emit(rec)
    assert rel <= FMA_RTOL and check["bit_equal_share"] >= FMA_EQUAL_SHARE, rec
    assert check["loop_effect_rel"] >= 100 * FMA_RTOL, rec
    assert check["rel_err_16_steps_short"] > FMA_RTOL, rec
    assert launches > 0, rec
    assert peak["flops_per_s"] <= PEAK_SLACK * roofline.H100_FP32_FLOPS, rec
    return dict(row, launches=launches, peak_flops_per_s=peak["flops_per_s"])


def phase_mpc(torch, np):
    """The sampling-MPC path at the bench_mpc width: one cold
    `cem_optimize_fused` solve (6 x 128 candidates x 200 steps on the 10^3
    design, 8 knots), 4 closed-loop segments through
    `make_fused_mpc_closed_loop`, K1 with knots alone against its plain
    version at the solve's shape and on the closed loop's plan and execute
    launches, and one CEM iteration through the eager rollout (50 of the 200
    steps) to show the plain path runs on the card."""
    import math
    import time

    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.control import (CEMConfig, cem_optimize,
                                           make_fused_mpc_closed_loop)
    from evosoro_tpu_torch.control.shooting import plan_inputs
    from evosoro_tpu_torch.ops import fused_rollout as fr

    # K1 with knots at the shape a solve launches it, against the plain version
    body, sim, env, dt = bench.mpc_workload(device="cuda")
    runner = fr.FusedBatchRunner(body, sim, env, batch=128, num_steps=200,
                                 num_knots=8, dt=dt)
    args = (runner.state_packed, runner.body_packed, runner.stats, None)
    kw = dict(runner.call_kwargs, control_packed=_controls(torch, np, 128, 8, 1000, 5))
    kw.pop("num_steps")
    knot_rec = _k1_cases(torch, fr, "MPC solve launch: 128 x 10^3, 8 knots", args,
                         kw, 128, False, (200,), time_at=200,
                         phase="k1_knots_vs_plain", knots=8)[0]
    # what the knot channel costs
    no_knots = dict(kw, control_packed=None, n_knots=0)
    times = dict(solve_launch_without_knots_ms=_event_ms(
        torch, lambda: fr.fused_call(*args, num_steps=200, **no_knots), 5))

    # the closed loop's two launches, on what the loop itself hands K1 after
    # an executed segment: the plan (32 candidates from the true state, CoM
    # capture reset, 200 steps, 8 knots) and the execution (ONE robot, its
    # carried stats row, 100 steps, 4 knots, the knot clock restarted)
    run, aux = make_fused_mpc_closed_loop(
        body, sim, env, 200, 8, exec_knots=4,
        config=CEMConfig(num_iters=1, pop_size=32), dt=dt, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    state, stats, _ = run(gen, 1, aux["state"], aux["stats"],
                          torch.zeros(aux["shape"], device="cuda"),
                          torch.full(aux["shape"], 0.02, device="cuda"))
    assert state.shape[0] == stats.shape[0] == 1 and float(stats[0, fr._S_TIME]) > 0
    runner = aux["runner"]
    plan_state, plan_stats = plan_inputs(state, stats, aux["P"])
    loop_recs = []
    for label, a, lkw, batch, k in (
            ("MPC plan launch: 32 x 10^3 from the true state, 8 knots",
             (plan_state, runner.body_packed, plan_stats, runner.collision_packed),
             aux["plan_kwargs"], aux["P"], 8),
            ("MPC execute launch: 1 x 10^3, the true state, 4 knots",
             (state, runner.body_packed, stats, runner.collision_packed),
             aux["exec_kwargs"], 1, 4)):
        lkw = dict(lkw, control_packed=_controls(torch, np, batch, k, 1000, 6))
        steps = lkw.pop("num_steps")
        assert lkw["n_knots"] == k and a[0].shape[0] == batch
        loop_recs += _k1_cases(torch, fr, label, a, lkw, batch, False, (steps,),
                               time_at=steps, phase="k1_knots_vs_plain", knots=k)
    times.update(plan_launch_ms=loop_recs[0]["ms"],
                 execute_launch_ms=loop_recs[1]["ms"])
    emit(dict(phase="mpc", what="K1 launch times at the MPC shapes",
              solve_launch_ms=knot_rec["ms"], **times))

    fr.FUSED_ROLLOUT_LAUNCHES = 0
    fr.FUSED_ROLLOUT_KNOT_LAUNCHES = 0
    fr.PAIR_CONTACT_LAUNCHES = 0
    rec = bench.mpc(device="cuda", segments=4)
    launches = dict(fused_rollout=fr.FUSED_ROLLOUT_LAUNCHES,
                    fused_rollout_with_knots=fr.FUSED_ROLLOUT_KNOT_LAUNCHES,
                    pair_contact=fr.PAIR_CONTACT_LAUNCHES)
    solve, closed = rec["solve"], rec["closed_loop"]
    k1_ms = knot_rec["ms"]
    solve.update(k1_ms_per_launch=k1_ms,
                 k1_share=solve["k1_launches_per_solve"] * k1_ms / solve["ms_per_solve"])
    emit(dict(phase="mpc", what="cold solve", **solve))
    emit(dict(phase="mpc", what="closed loop", **closed))
    emit(dict(phase="mpc_launches", **launches))
    trace = solve["best_cost_trace"]
    assert all(math.isfinite(c) for c in trace), solve
    assert all(b <= a for a, b in zip(trace, trace[1:])), solve
    assert solve["max_abs_u"] <= solve["u_clip"] + 1e-7, solve
    assert solve["best_cost"] < 1e9, solve
    assert solve["k1_launches_per_solve"] == solve["num_iters"] == 6, solve
    assert abs(closed["final_time"] - closed["expected_time"]) \
        <= 1e-5 * closed["expected_time"], closed
    assert all(math.isfinite(c) and c < 1e9 for c in closed["planned_costs"]), closed
    assert not closed["diverged"] and closed["executed_norm_dist"] > 0, closed
    assert closed["k1_launches"] == 4 * (1 + 1), closed
    assert launches["fused_rollout_with_knots"] == launches["fused_rollout"] > 0

    # the plain path: one CEM iteration through the eager rollout
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, info = cem_optimize(gen, body, sim, env, 50, 8,
                           CEMConfig(num_iters=1, pop_size=8), dt=dt, device="cuda")
    best = float(info["best_cost"])
    emit(dict(phase="mpc", what="one cem_optimize iteration, eager rollout",
              pop_size=8, steps=50, steps_cut_from=200,
              seconds=time.perf_counter() - t0, best_cost=best))
    assert math.isfinite(best) and best < 1e9
    return launches, knot_rec, loop_recs


# channel groups of the state cotangent (ops/fused_rollout.py channel map)
_COT_GROUPS = dict(pos=(0, 3), quat=(3, 7), linmom=(7, 10), angmom=(10, 13),
                   scale=(13, 14), last_pos2=(17, 26), last_angle1=(26, 35),
                   last_angle2=(35, 44), max_strain=(44, 47))


def _b4_errors(torch, got, ref):
    """Per group: largest |got - ref| over the group's largest |ref| (the
    absolute error where the plain group is all zero), for the state
    cotangent's groups and the controls' cotangent. Returns (worst, dict)."""
    (cs_k, cu_k), (cs_p, cu_p) = got, ref
    rel = {}
    for name, (a, b) in _COT_GROUPS.items():
        top = float(cs_p[:, a:b].abs().max())
        err = float((cs_k[:, a:b] - cs_p[:, a:b]).abs().max())
        rel[name] = err / top if top > 0 else err
    top = float(cu_p.abs().max())
    rel["controls"] = float((cu_k - cu_p).abs().max()) / top if top > 0 else \
        float((cu_k - cu_p).abs().max())
    return max(rel.values()), rel


def _b4_case(torch, np, fr, label, state, body, stats, ctrl, seg_base, kw, seed,
             zero_cot=False, timed=False, guards=()):
    """B4 against `fused_bwd_plain` on one input, with the two guards in the
    data: a launch one step short and the controls' cotangent moved to the
    neighbouring knot must both fail the comparison; and each of `guards`
    (`_b4_guards`: a plain version with one term of the adjoint wrong) must
    fail it too."""
    from unittest import mock

    from evosoro_tpu_torch import roofline

    B, _, V = state.shape
    rng = np.random.default_rng(seed)
    cot = rng.standard_normal((B, fr.C_S, V)).astype(np.float32)
    cot[:, fr._TSAVG:] = 0.0
    cot = torch.as_tensor(cot, device="cuda")
    if zero_cot:
        cot.zero_()
    before = fr.FUSED_BWD_LAUNCHES
    got = fr.fused_bwd_call(state, body, stats, ctrl, seg_base, cot, **kw)
    torch.cuda.synchronize()
    assert fr.FUSED_BWD_LAUNCHES == before + 1
    plain_ms = []  # the reference run is the timed plain version
    ref = _timed_once(torch, plain_ms, timed,
                      lambda: fr.fused_bwd_plain(state, body, stats, ctrl, seg_base, cot, **kw))
    torch.cuda.synchronize()
    worst, rel = _b4_errors(torch, got, ref)
    finite = all(bool(torch.isfinite(t).all()) for t in (*got, *ref))
    rec = dict(phase="b4_vs_plain", workload=label, batch=B, steps=kw["num_steps"],
               seg_base=seg_base, knots=kw["n_knots"], body_per_robot=body.shape[0] > 1,
               floor=bool(kw["flags"]["floor"]), gravity=bool(kw["flags"]["gravity"]),
               rel_err=rel, worst_rel_err=worst, tol=B4_REL_TOL, finite=finite,
               sha256=_digest("b4/" + label, *got),
               max_abs_err=float((got[1] - ref[1]).abs().max()),
               max_abs_cot_ctrl=float(ref[1].abs().max()),
               max_abs_cot_state=float(ref[0].abs().max()),
               tail_channels_zero=bool((got[0][:, fr._TSAVG:] == 0).all()
                                       and (got[0][:, fr._SMALL:fr._SMALL + 3] == 0).all()))
    ok = finite and worst <= B4_REL_TOL and rec["tail_channels_zero"]
    if zero_cot:
        rec["all_zero"] = bool((got[0] == 0).all() and (got[1] == 0).all())
        ok = ok and rec["all_zero"]
    else:
        assert rec["max_abs_cot_ctrl"] > 0, rec
        short = fr.fused_bwd_call(state, body, stats, ctrl, seg_base, cot,
                                  **dict(kw, num_steps=kw["num_steps"] - 1))
        rec["guard_one_step_short"] = _b4_errors(torch, short, ref)[0]
        moved = (got[0], torch.roll(got[1], 1, dims=1))
        rec["guard_neighbouring_knot"] = _b4_errors(torch, moved, ref)[0]
        ok = ok and rec["guard_one_step_short"] > B4_REL_TOL \
            and rec["guard_neighbouring_knot"] > B4_REL_TOL
    for name, module, attr, fn in guards:
        with mock.patch.object(module, attr, fn):
            wrong = fr.fused_bwd_plain(state, body, stats, ctrl, seg_base, cot, **kw)
        rec[f"guard_{name}"] = _b4_errors(torch, got, wrong)[0]
        ok = ok and rec[f"guard_{name}"] > B4_REL_TOL
    if timed:
        # blocks a robot, threads a block, where the buffer and slabs lie
        # (`--land` runs in older trees too, which lack the cluster)
        if hasattr(fr, "b4_launch_shape"):
            rec["launch_shape"] = fr.b4_launch_shape(B, kw["grid_shape"], kw["flags"])
        rec["ms"] = _event_ms(torch, lambda: fr.fused_bwd_call(
            state, body, stats, ctrl, seg_base, cot, **kw), 5)
        rec["plain_ms"] = plain_ms[0]
        rec["k1_ms"] = _event_ms(torch, lambda: fr.fused_call(
            state, body, stats, None, control_packed=ctrl, seg_base=seg_base, **kw), 5)
        _, st_end = fr.fused_call(state, body, stats, None, control_packed=ctrl,
                                  seg_base=seg_base, **kw)
        steps = torch.round((st_end[:, fr._S_TIME] - stats[:, fr._S_TIME])
                            / stats[:, fr._S_DT])
        rec["steps_taken"] = steps.tolist()
        flags = kw["flags"]
        land = not (flags.get("fluid") or flags.get("nonlinear") or flags.get("max_vel")
                    or any(flags.get(k) for k in fr._K1_DEVO_FLAGS))
        # (the land call keeps the arguments `--land` runs with in older trees)
        variant = {} if land else dict(flags=flags, grid_shape=kw["grid_shape"])
        rec.update(roofline.bound(*roofline.b4_work(state, body, stats, ctrl, steps,
                                                    **variant)))
    rec["ok"] = ok
    emit(rec)
    assert ok, rec
    return rec


def phase_b4(torch, np):
    """B4 against `fused_bwd_plain` (torch autograd through the plain
    version) with a random cotangent on every carried channel: the SQP
    solver's launch (8 x 10^3, 25 steps of a 200-step clock, 8 knots) from
    rest at seg_base 0 and from the state K1 reaches at seg_base 75 under
    random controls, without floor and gravity (the SQP workload) and with
    them (the default env); a batch with a body per robot (4 x 6^3 of the
    evaluator's designs, contact off); and an all-zero cotangent. Returns
    the records; the timed one is the SQP launch at seg_base 75."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.core.rollout import init_state
    from evosoro_tpu_torch.core.types import EnvParams
    from evosoro_tpu_torch.ops import fused_rollout as fr

    recs = []
    body, sim, _, dt = bench.mpc_workload(device="cuda")
    B, K, S, total = 8, 8, 25, 200
    body_packed = fr.pack_body(body)
    state0 = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
    grid = tuple(body.occ.shape)
    ctrl = _controls(torch, np, B, K, body.occ.numel(), seed=11)
    for env in (EnvParams(gravity_enabled=False, floor_enabled=False), EnvParams()):
        stats0 = fr.make_stats(body, B, dt, sim, env)
        kw = dict(num_steps=S, grid_shape=grid,
                  scalars=fr.kernel_scalars(body.nominal_size, sim, env),
                  flags=dict(fr.kernel_env_flags(sim, env), **fr.body_flags(body),
                             collision=False, segmented=True),
                  n_knots=K, total_steps=total)
        off = not env.floor_enabled
        label = "SQP launch %d x %d^3, " % (B, grid[0]) + ("no floor, no gravity" if off
                                           else "floor and gravity")
        recs.append(_b4_case(torch, np, fr, label + ", from rest", state0, body_packed,
                             stats0, ctrl, 0, kw, seed=1))
        st75, ss75 = fr.fused_call(state0, body_packed, stats0, None, control_packed=ctrl,
                                   seg_base=0, **dict(kw, num_steps=75))
        recs.append(_b4_case(torch, np, fr, label + ", 75 steps in", st75, body_packed,
                             ss75, ctrl, 75, kw, seed=2, timed=off))
        if off:
            recs.append(_b4_case(torch, np, fr, label + ", zero cotangent", st75,
                                 body_packed, ss75, ctrl, 75, kw, seed=3, zero_cot=True))

    (state, bodies, stats, _), ekw = bench.evaluator_workload(collision=False,
                                                              device="cuda")
    state, bodies, stats = (t[:4].contiguous() for t in (state, bodies, stats))
    kw = dict(ekw, num_steps=25, flags=dict(ekw["flags"], segmented=True),
              n_knots=4, total_steps=100)
    ctrl = _controls(torch, np, 4, 4, state.shape[2], seed=12)
    st25, ss25 = fr.fused_call(state, bodies, stats, None, control_packed=ctrl,
                               seg_base=0, **kw)
    recs.append(_b4_case(torch, np, fr, "evaluator designs 4 x 6^3, a body per robot",
                         st25, bodies, ss25, ctrl, 25, kw, seed=4))
    return recs


def phase_b4_against(torch, np, against):
    """B4 in turns with checkout `against`'s (`--diff --against`), through
    `buildcmp.in_turns` on B4's library: the arms are the other tree's B4,
    this one with a block a robot (C = 1, `b4_launch_shape` asked for one)
    and this one as it launches, in order and back, twice. The workloads
    are the SQP solve's B4 launch (`buildcmp.sqp_b4_launch`: 25 steps at
    seg_base 75, 8 knots, 8 robots) on land, in water with each drag model
    (11^3 with the shell), with growth (5x5x4), on the bilinear palette with
    the clamp (10^3) and on land at 12^3 (the device-memory twin), and the
    land launch at 32 x 10^3 and 16 x 11^3 (clusters of which the card must
    hold the whole batch at once) and at 133 x 11^3 (a block a robot, its
    slabs in device memory beside the recompute's buffer in shared memory),
    each with this tree's launch shape and with the assertion that every arm
    gives the same bits; then one re-plan of each `bench.sqp` variant (a
    cold solve and one re-plan a turn; ms a re-plan), and the land launch's
    split between its recompute and its reverse sweep (`buildcmp.b4_split`)
    in this tree and in the other where its B4 has `b4_recompute`. Returns
    the records."""
    from pathlib import Path
    from unittest import mock

    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.buildcmp import b4_split, in_turns, launchers, sqp_b4_launch
    from evosoro_tpu_torch.ops import fused_rollout as fr

    shape = fr.b4_launch_shape

    def one_block():
        return mock.patch.object(fr, "b4_launch_shape",
                                 lambda B, grid, flags, cluster=0: shape(B, grid, flags, 1))

    calls = launchers(against, name="fused_rollout_bwd")
    arms = {"parent": calls["other"], "this_one_block": (calls["this"], one_block),
            "this": calls["this"]}
    recs = []
    for label, wkw in (("land 8 x 10^3", {}), ("face drag 8 x 11^3", dict(fluid="face")),
                       ("facet drag 8 x 11^3", dict(fluid="mesh")),
                       ("growth 8 x 5x5x4", dict(devo=True)),
                       ("materials 8 x 10^3", dict(materials=True)),
                       ("land 8 x 12^3", dict(n=12)), ("land 32 x 10^3", dict(B=32)),
                       ("land 16 x 11^3", dict(n=11, B=16)),
                       ("land 133 x 11^3", dict(n=11, B=133))):
        st, body, stats, ctrl, cot, kw = sqp_b4_launch(**wkw)

        def run():
            return fr.fused_bwd_call(st, body, stats, ctrl, 75, cot, **kw)

        times, same = in_turns(arms, lambda: bench.time_call(run, 3, 5), run, 2,
                               lib="fused_rollout_bwd")
        B = st.shape[0]
        grid, flags = kw["grid_shape"], kw["flags"]
        t0 = time.perf_counter()
        for _ in range(100):
            shape(B, grid, flags)
        rec = dict(phase="b4_turns", workload=label, steps=25, turns=times,
                   **{arm + "_ms": min(t) for arm, t in times.items()},
                   bit_equal_across_arms=same, this_shape=shape(B, grid, flags),
                   one_block_shape=shape(B, grid, flags, 1),
                   shape_query_us=(time.perf_counter() - t0) * 1e4)
        emit(rec)
        assert same, rec
        recs.append(rec)
        del st, body, stats, ctrl, cot
    roots = {"this": HERE}
    if "b4_recompute" in (Path(against) / "evosoro_tpu_torch" / "ops" / "csrc"
                          / "fused_rollout_bwd.cuh").read_text():
        roots = {"parent": against, **roots}
    split = dict(phase="b4_split", workload="land 8 x 10^3", **b4_split(roots))
    emit(split)
    recs.append(split)
    for label, skw in (("land", {}), ("facet drag", dict(fluid="mesh")),
                       ("face drag", dict(fluid="face")), ("growth", dict(devo=True)),
                       ("materials", dict(materials=True)), ("land 12^3", dict(n=12))):
        times, _ = in_turns(arms, lambda: bench.sqp(device="cuda", replans=1, **skw)[
            "ms_per_solve"], tuple, 1, lib="fused_rollout_bwd")
        rec = dict(phase="sqp_replan_turns", workload=label, ms_per_replan=times)
        emit(rec)
        recs.append(rec)
    return recs


def _b4_guards(torch, model):
    """The defects the B4 comparison must see in each variant, each a plain
    version with one term of the adjoint wrong, as (name, module, attribute,
    replacement) for `mock.patch.object`: with growth the clamps' cotangent
    dropped (the scale update detached from the graph); in water the drag's
    adjoint dropped (the drag force detached) and, with the facet drag, each
    facet's vertex cotangent sent to its owner's own corner at that vertex
    instead of to the voxels the vertex averages, the drag's value kept."""
    from evosoro_tpu_torch.core import quaternion as qt
    from evosoro_tpu_torch.core import step as step_mod
    from evosoro_tpu_torch.envs import drag as drag_mod

    if model == "devo":
        scale_update = step_mod._scale_update

        def clamp_dropped(state, body, sim, env, t):
            scale, devo = scale_update(state, body, sim, env, t)
            return scale.detach(), devo

        return [("clamp_dropped", step_mod, "_scale_update", clamp_dropped)]
    if model == "face":
        face = step_mod._fluid_drag
        return [("drag_dropped", step_mod, "_fluid_drag", lambda *a: face(*a).detach())]
    mesh = drag_mod.mesh_drag_forces

    def own_corner(pos, quat, scale, linmom, mass_inv, sys, c_drag, strain_pos=None,
                   strain_neg=None, nominal_size=None):
        assert sys.vert_vox.dim() == 2, "one design's tables"
        B, X, Y, Z, _ = pos.shape
        posf, quatf = pos.reshape(B, -1, 3), quat.reshape(B, -1, 4)
        spf = strain_pos.reshape(B, 3, -1).transpose(1, 2)
        snf = strain_neg.reshape(B, 3, -1).transpose(1, 2)

        def coords(flat):
            return torch.stack([flat // (Y * Z), (flat // Z) % Y, flat % Z], -1)

        # the true vertices, and each vertex's lattice corner
        sel = torch.where(sys.vert_sign > 0, spf[:, sys.vert_vox], snf[:, sys.vert_vox])
        world = posf[:, sys.vert_vox] + qt.quat_rotate(
            quatf[:, sys.vert_vox], sys.vert_sign * (0.5 * nominal_size) * (1.0 + sel))
        vpos = (world * sys.vert_w[..., None]).sum(-2) / torch.clamp(
            sys.vert_w.sum(-1), min=1.0)[..., None]
        vcorner = coords(sys.vert_vox[:, 0]) + (sys.vert_sign[:, 0] > 0).long()
        own = sys.tri_owner
        tri = []
        for j in range(3):
            vid = sys.tri_verts[:, j]
            sign = (2 * (vcorner[vid] - coords(own)) - 1).to(pos.dtype)
            s = torch.where(sign > 0, spf[:, own], snf[:, own])
            corner = posf[:, own] + qt.quat_rotate(quatf[:, own],
                                                    sign * (0.5 * nominal_size) * (1.0 + s))
            tri.append(vpos[:, vid].detach() + corner - corner.detach())
        a, b, c = tri
        n = torch.linalg.cross(b - a, c - a)
        n_len = torch.sqrt(torch.clamp((n * n).sum(-1), min=1e-30))
        n_hat = n / n_len[..., None]
        vel = (linmom * mass_inv[..., None]).reshape(B, -1, 3)[:, own]
        vn = (vel * n_hat).sum(-1)
        cd = c_drag[:, None] if torch.is_tensor(c_drag) and c_drag.dim() > 0 else c_drag
        mag = torch.where(sys.tri_mask & (vn > 0), cd * (0.5 * n_len) * vn * vn, 0.0)
        out = torch.zeros_like(posf)
        out.index_add_(1, own, -mag[..., None] * n_hat)
        return out.reshape(pos.shape)

    return [("drag_dropped", drag_mod, "mesh_drag_forces",
             lambda *a, **k: mesh(*a, **k).detach()),
            ("own_corner_only", drag_mod, "mesh_drag_forces", own_corner)]


# B4's variants: (model, bench.sqp_workload's arguments, label, the K1
# counter and the B4 counter of its launches, by phase_sqp_variants' names)
B4_VARIANTS = (
    ("mesh", dict(fluid="mesh"), "facet drag", "fused_rollout_mesh", "fused_bwd_mesh"),
    ("face", dict(fluid="face"), "voxel-face drag", "fused_rollout_fluid", "fused_bwd_fluid"),
    ("devo", dict(devo=True), "growth", "fused_rollout_devo", "fused_bwd_devo"))


def phase_b4_variants(torch, np):
    """B4's fluid and development instances against `fused_bwd_plain` on
    the SQP solver's launch of each variant (`bench.sqp_workload`: 8 x 10^3
    in its 11^3 shell with the facet and with the voxel-face drag, and the
    growth design 8 x 5x5x4; 25 steps of a 200-step clock, 8 knots) from
    rest and from the
    state K1 reaches 75 steps in under random controls (timed), with a
    random cotangent; then each variant's guards
    (`_b4_guards`) on the launch 75 steps in where they weigh: in water at
    200 x the drag coefficient from momenta perturbed so that facets face
    forward on every side, with growth under clamp bounds that keep the old
    scale now and then. The K1 launches of the same solve are held against
    the plain version at the variant's tolerances (the facet drag's
    `MESH_TOL`): the 75 steps from rest in segmented mode with the knots,
    and the 25-step segment at seg_base 75 from where they end, which with
    its knots zeroed must fail the comparison. Returns
    ({model: B4 records}, {model: K1 records})."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.core.rollout import init_state
    from evosoro_tpu_torch.ops import fused_rollout as fr

    B, K, S, total = 8, 8, 25, 200
    out, k1 = {}, {}
    for model, wkw, name, _, _ in B4_VARIANTS:
        body, sim, env, dt = bench.sqp_workload(device="cuda", **wkw)
        body_packed = fr.pack_body(body)
        state0 = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
        stats0 = fr.make_stats(body, B, dt, sim, env)
        kw = dict(num_steps=S, grid_shape=tuple(body.occ.shape),
                  scalars=fr.kernel_scalars(body.nominal_size, sim, env),
                  flags=fr.launch_flags(body, sim, env, collision=False, segmented=True),
                  n_knots=K, total_steps=total)
        V = body.occ.numel()
        ctrl = _controls(torch, np, B, K, V, seed=21)
        label = "SQP launch %d x %s, %s" % (B, "x".join(map(str, body.occ.shape)), name)
        recs = [_b4_case(torch, np, fr, label + ", from rest", state0, body_packed, stats0,
                         ctrl, 0, kw, seed=5)]
        k1_kw = {k: v for k, v in kw.items() if k != "num_steps"}
        k1_kw["control_packed"] = ctrl
        opts = dict(phase="k1_sqp_launch_vs_plain", tol=MESH_TOL if model == "mesh" else TOL,
                    model=model, knots=K)
        k1[model] = _k1_cases(torch, fr, label + ", from rest",
                              (state0, body_packed, stats0, None), dict(k1_kw, seg_base=0),
                              B, False, (75,), **opts)
        st75, ss75 = fr.fused_call(state0, body_packed, stats0, None, control_packed=ctrl,
                                   seg_base=0, **dict(kw, num_steps=75))
        k1[model] += _k1_cases(torch, fr, label + ", 75 steps in",
                               (st75, body_packed, ss75, None), dict(k1_kw, seg_base=75),
                               B, False, (S,), **opts)
        # guard: the segment with its knots zeroed must fail against the plain
        # version with them (the knots reach the scale through the variant's
        # fluid_scale or development_scale)
        seg = (st75, body_packed, ss75, None)
        out_z, st_z = fr.fused_call(*seg, num_steps=S, **dict(
            k1_kw, seg_base=75, control_packed=torch.zeros_like(ctrl)))
        out_p, st_p = _plain(fr, *seg, num_steps=S, **dict(k1_kw, seg_base=75))
        passes, errs = _compare(torch, fr, out_z, st_z, out_p, st_p, opts["tol"])
        rec = dict(phase="k1_sqp_launch_guard", workload=label + ", 75 steps in, knots zeroed",
                   passes=passes, scale_err=errs["scale"], ok=not passes)
        emit(rec)
        assert rec["ok"], rec
        recs.append(_b4_case(torch, np, fr, label + ", 75 steps in", st75, body_packed, ss75,
                             ctrl, 75, kw, seed=6, timed=True))
        gs, gss = st75.clone(), ss75.clone()
        if model == "devo":
            gss[:, fr._S_MINTF] = 0.9995
            gss[:, fr._S_GAMP] = 5e-4
            what = "clamp bounds 0.9995 L and 1.0005 L"
        else:
            gss[:, fr._S_DRAGC] = STRONG_DRAG
            rng = np.random.default_rng(7)
            occ = (body_packed[:, fr._B_OCC] > 0.5).float()
            for a, b in ((fr._LIN, fr._LIN + 3), (fr._ANG, fr._ANG + 3)):
                noise = torch.as_tensor(rng.standard_normal((B, 3, V)).astype(np.float32),
                                        device="cuda")
                gs[:, a:b] += 3 * noise * gs[:, a:b].abs().max() * occ[:, None]
            what = "drag %g, momenta perturbed" % STRONG_DRAG
        recs.append(_b4_case(torch, np, fr, label + ", 75 steps in, " + what, gs.contiguous(),
                             body_packed, gss.contiguous(), ctrl, 75, kw, seed=7,
                             guards=_b4_guards(torch, model)))
        out[model] = recs
    return out, k1


def _material_guards(torch):
    """The defects the comparison of B4's material instance must see, each a
    plain version with one term of the adjoint wrong, as (name, module,
    attribute, replacement) for `mock.patch.object`: the nonlinear stress's
    slope replaced by the linear stiffness (its value kept), and the
    max-velocity clamp's factor detached (its projection dropped)."""
    from evosoro_tpu_torch.core import step as step_mod

    nonlinear, clamp = step_mod._nonlinear_stress, step_mod._max_vel_clamp

    def linear_slope(d, strain, body):
        stress, sv1, sv2 = nonlinear(d, strain, body)
        e1, e2 = body.bond_e1[..., d, :, :, :], body.bond_e2[..., d, :, :, :]
        s_sum = e1 + e2
        hom = body.bond_homogeneous[..., d, :, :, :] | (
            torch.abs(e1 - e2) <= 0.0005 * torch.abs(s_sum))
        stiff = torch.where(hom, 0.5 * s_sum, body.bond_e[..., d, :, :, :])
        return stress.detach() + stiff * (strain - strain.detach()), sv1, sv2

    def factor_detached(disp, limit):
        out = clamp(disp, limit)
        nz = disp != 0
        return disp * torch.where(nz, out / torch.where(nz, disp, 1.0), 1.0).detach()

    return [("linear_slope", step_mod, "_nonlinear_stress", linear_slope),
            ("clamp_factor_detached", step_mod, "_max_vel_clamp", factor_detached)]


def _material_branches(torch, fr, state, body, stats, ctrl, seg_base, kw):
    """(bond-steps past a bilinear side's yield strain, voxel-steps the
    clamp scaled back) of the plain version's forward run of a launch."""
    from unittest import mock

    from evosoro_tpu_torch.core import step as step_mod

    nonlinear, clamp = step_mod._nonlinear_stress, step_mod._max_vel_clamp
    counts = [0, 0]

    def past(mm, ys, e, sv):
        return (mm == 2) & (sv > step_mod._safe_div(ys, e))

    def counted_stress(d, strain, b):
        out = nonlinear(d, strain, b)
        side = (b.mat_model_vox, b.yield_stress, b.e_mod)
        yielded = past(*side, out[1]) | past(*(step_mod._nbr(a, d) for a in side), out[2])
        counts[0] += int((yielded & b.bond_mask[..., d, :, :, :]).sum())
        return out

    def counted_clamp(disp, limit):
        counts[1] += int((step_mod._safe_norm(*disp.unbind(-1)) > limit).sum())
        return clamp(disp, limit)

    with mock.patch.object(step_mod, "_nonlinear_stress", counted_stress), \
            mock.patch.object(step_mod, "_max_vel_clamp", counted_clamp):
        fr.fused_rollout_plain(state, body, stats, None, control_packed=ctrl,
                               seg_base=seg_base, **kw)
    return counts


def _b4_tape(torch, fr, *args, **kw):
    """(cotangents, tape) of one `fused_bwd_call` on the card: the tape its
    forward recompute wrote, the first 4-d tensor the wrapper allocates."""
    from unittest import mock

    real, kept = torch.empty, []

    def empty(*a, **k):
        t = real(*a, **k)
        if not kept and t.dim() == 4:
            kept.append(t)
        return t

    with mock.patch.object(torch, "empty", empty):
        out = fr.fused_bwd_call(*args, **kw)
    torch.cuda.synchronize()
    return out, kept[0]


def phase_b4_materials(torch, np):
    """B4's material instance (bilinear stress through the stress
    equalization, the max-velocity clamp) against `fused_bwd_plain` on the
    SQP solver's launch of `bench.sqp_workload(materials=True)` (8 x 10^3 on
    the bilinear palette with the clamp, 25 steps of a 200-step clock, 8
    knots), from rest
    and from the state K1's material instance reaches 75 steps in under
    random controls (timed), with a random cotangent; each
    record counts the plain version's bond-steps past yield and clamped
    voxel-steps, both > 0. Its guards: the slope replaced by the linear
    stiffness, the clamp's factor detached (`_material_guards`) and a
    launch one step short. B4's recomputed end state (the tape's last slot)
    equals K1's material launch bit for bit. The device-memory twin, forced,
    equals the shared instance bit for bit at 10^3, and at 12^3 (where it
    runs by itself) is held against the plain version. Returns the records;
    the timed one is the launch 75 steps in."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.core.rollout import init_state
    from evosoro_tpu_torch.ops import fused_rollout as fr

    B, K, S, total = 8, 8, 25, 200
    recs = []
    launches = {}
    for n in (10, 12):
        body, sim, env, dt = bench.sqp_workload(n=n, device="cuda", materials=True)
        body_packed = fr.pack_body(body)
        state0 = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
        stats0 = fr.make_stats(body, B, dt, sim, env)
        kw = dict(num_steps=S, grid_shape=tuple(body.occ.shape),
                  scalars=fr.kernel_scalars(body.nominal_size, sim, env),
                  flags=fr.launch_flags(body, sim, env, collision=False, segmented=True),
                  n_knots=K, total_steps=total)
        assert kw["flags"]["nonlinear"] and kw["flags"]["max_vel"], kw["flags"]
        ctrl = _controls(torch, np, B, K, body.occ.numel(), seed=41)
        label = "SQP launch %d x %d^3, bilinear palette, clamp" % (B, n)
        st75, ss75 = fr.fused_call(state0, body_packed, stats0, None, control_packed=ctrl,
                                   seg_base=0, **dict(kw, num_steps=75))
        starts = [("from rest", state0, stats0, 0), ("75 steps in", st75, ss75, 75)]
        if n == 12:
            starts = starts[1:]
        for where, st, ss, base in starts:
            yielded, clamped = _material_branches(torch, fr, st, body_packed, ss, ctrl, base,
                                                  kw)
            m0, g0 = fr.FUSED_BWD_MATERIAL_LAUNCHES, fr.FUSED_BWD_GMEM_LAUNCHES
            rec = _b4_case(torch, np, fr, "%s, %s" % (label, where), st, body_packed, ss, ctrl,
                           base, kw, seed=8, timed=(n == 10 and base == 75),
                           guards=_material_guards(torch) if n == 10 else ())
            launches[(n, base)] = (fr.FUSED_BWD_MATERIAL_LAUNCHES - m0,
                                   fr.FUSED_BWD_GMEM_LAUNCHES - g0)
            rec.update(bond_steps_past_yield=yielded, voxel_steps_clamped=clamped)
            assert yielded > 0 and clamped > 0, rec
            if n == 12:  # the device-memory instance ran by itself
                assert fr.b4_launch_shape(B, kw["grid_shape"], kw["flags"])["instance"] \
                    == "device"
                assert launches[(n, base)][1] >= 1, launches
            else:
                # the recompute is K1's material launch, bit for bit; the twin,
                # forced, computes the shared instance's bits
                cot = torch.as_tensor(np.random.default_rng(8).standard_normal(
                    st.shape).astype(np.float32), device="cuda")
                cot[:, fr._TSAVG:] = 0.0
                got, tape = _b4_tape(torch, fr, st, body_packed, ss, ctrl, base, cot, **kw)
                end, _ = fr.fused_call(st, body_packed, ss, None, control_packed=ctrl,
                                       seg_base=base, **kw)
                rec["recompute_bit_equal_k1"] = torch.equal(tape[:, S, :fr._TSAVG],
                                                            end[:, :fr._TSAVG])
                with _device_instances(fr):
                    twin = fr.fused_bwd_call(st, body_packed, ss, ctrl, base, cot, **kw)
                torch.cuda.synchronize()
                rec["twin_bit_equal"] = all(torch.equal(a, b) for a, b in zip(twin, got))
                assert rec["recompute_bit_equal_k1"] and rec["twin_bit_equal"], rec
            emit(dict(phase="b4_materials", workload=rec["workload"],
                      bond_steps_past_yield=yielded, voxel_steps_clamped=clamped,
                      material_launches=launches[(n, base)][0],
                      device_memory_launches=launches[(n, base)][1],
                      **{k: rec[k] for k in ("recompute_bit_equal_k1", "twin_bit_equal")
                         if k in rec}))
            recs.append(rec)
    return recs


def phase_sqp_materials(torch, b4_mat):
    """The gradient-MPC path on the bilinear palette with the max-velocity
    clamp: `bench.sqp(materials=True)` (a cold `FusedSQPSolver.solve` and
    three re-plans, 200 steps in 8 segments, 8 knots, 4 iterations on 8 x
    10^3), every launch counter set to 0 just before and read just after:
    its 4 x 72 K1 launches are the material instance's, its 4 x 32 B4
    launches B4's material instance. Returns the launches."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.ops import fused_rollout as fr

    counters = dict(fused_rollout="FUSED_ROLLOUT_LAUNCHES",
                    fused_rollout_with_knots="FUSED_ROLLOUT_KNOT_LAUNCHES",
                    fused_rollout_material="FUSED_ROLLOUT_MATERIAL_LAUNCHES",
                    fused_bwd="FUSED_BWD_LAUNCHES",
                    fused_bwd_material="FUSED_BWD_MATERIAL_LAUNCHES",
                    fused_bwd_gmem="FUSED_BWD_GMEM_LAUNCHES")
    for name in counters.values():
        setattr(fr, name, 0)
    rec = bench.sqp(device="cuda", materials=True)
    launches = {k: getattr(fr, name) for k, name in counters.items()}
    timed = next(r for r in b4_mat if "ms" in r)
    k1_ms, b4_ms = timed["k1_ms"], timed["ms"]
    rec.update(k1_ms_per_launch=k1_ms, b4_ms_per_launch=b4_ms,
               k1_share=rec["k1_launches_per_solve"] * k1_ms / rec["ms_per_solve"],
               b4_share=rec["b4_launches_per_solve"] * b4_ms / rec["ms_per_solve"])
    emit(dict(phase="sqp", what="FusedSQPSolver: cold solve and re-plans, bilinear "
              "palette with the max-velocity clamp", **rec))
    emit(dict(phase="sqp_launches", model="materials", **launches))
    _sqp_checks(rec, launches)
    assert launches["fused_rollout_material"] == 4 * 72, launches
    assert launches["fused_bwd_material"] == 4 * 32 and launches["fused_bwd_gmem"] == 0, launches
    return launches


def _b4_material_row(b4_mat, launches, bound_keys):
    """The kernels line's row of B4's material instance."""
    timed = next(r for r in b4_mat if "ms" in r)
    guards = {k: v for r in b4_mat for k, v in r.items() if k.startswith("guard_")}
    return dict(
        name="fused_rollout_bwd (B4), material instance", route="cuda",
        source="evosoro_tpu_torch/ops/csrc/fused_rollout_bwd_mat.cu",
        replaces="evosoro_tpu/ops/fused_rollout.py:2745",
        launches=launches["fused_bwd_material"],
        launches_of="bench.sqp(materials=True): a cold solve and 3 re-plans",
        **bound_keys(timed),
        max_abs_err=max(r["max_abs_err"] for r in b4_mat),
        worst_rel_err=max(r["worst_rel_err"] for r in b4_mat), guards=guards,
        bond_steps_past_yield=min(r["bond_steps_past_yield"] for r in b4_mat),
        voxel_steps_clamped=min(r["voxel_steps_clamped"] for r in b4_mat),
        err_of=("cotangent of the controls, against autograd through the plain version: "
                "the SQP launch 8 x 10^3 x 25 steps on the bilinear palette with the clamp, "
                "8 knots, from rest and 75 steps in, and 8 x 12^3 75 steps in "
                "(the device-memory twin); worst_rel_err as the land row"),
        ms=timed["ms"], plain_ms=timed["plain_ms"], launch_shape=timed["launch_shape"],
        ms_of="one launch of a solve: %s" % timed["workload"])


def _sqp_checks(rec, launches):
    """What a `bench.sqp` run must show: finite costs that fall, an accepted
    step, controls inside the box, and 72 K1 and 32 B4 launches a solve
    (a cold solve and 3 re-plans)."""
    import math

    trace = rec["cost_trace"]
    assert all(math.isfinite(c) for c in trace + rec["replan_final_costs"]), rec
    assert math.isfinite(rec["final_cost"]) and any(rec["accepted_trace"]), rec
    assert rec["best_cost"] <= trace[0] and rec["final_cost"] < trace[0], rec
    assert rec["max_abs_u"] <= rec["u_clip"] + 1e-7, rec
    n_it, n_res = rec["num_iters"], rec["n_res"]
    assert rec["k1_launches_per_solve"] == (2 * n_it + 1) * n_res == 72, rec
    assert rec["b4_launches_per_solve"] == n_it * n_res == 32, rec
    assert launches["fused_rollout"] == launches["fused_rollout_with_knots"] == 4 * 72
    assert launches["fused_bwd"] == 4 * 32, launches


def phase_sqp_variants(torch, b4_var):
    """The gradient-MPC path in water and with growth at the bench_mpc width:
    `bench.sqp(fluid="mesh")`, `(fluid="face")` and `(devo=True)` (a cold
    `FusedSQPSolver.solve` and three re-plans, 200 steps in 8 segments, 8
    knots, 4 iterations; `bench.sqp_workload`), every launch counter set to
    0 just before each and read just after: each run's 4 x 72 K1 and 4 x 32
    B4 launches are its variant's. Returns {model: launches}."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.ops import fused_rollout as fr

    counters = dict(fused_rollout="FUSED_ROLLOUT_LAUNCHES",
                    fused_rollout_with_knots="FUSED_ROLLOUT_KNOT_LAUNCHES",
                    fused_rollout_fluid="FUSED_ROLLOUT_FLUID_LAUNCHES",
                    fused_rollout_mesh="FUSED_ROLLOUT_MESH_LAUNCHES",
                    fused_rollout_devo="FUSED_ROLLOUT_DEVO_LAUNCHES",
                    fused_bwd="FUSED_BWD_LAUNCHES", fused_bwd_fluid="FUSED_BWD_FLUID_LAUNCHES",
                    fused_bwd_mesh="FUSED_BWD_MESH_LAUNCHES",
                    fused_bwd_devo="FUSED_BWD_DEVO_LAUNCHES")
    out = {}
    for model, wkw, _, k1_key, b4_key in B4_VARIANTS:
        for name in counters.values():
            setattr(fr, name, 0)
        rec = bench.sqp(device="cuda", **wkw)
        launches = {k: getattr(fr, name) for k, name in counters.items()}
        timed = next(r for r in b4_var[model] if "ms" in r)
        k1_ms, b4_ms = timed["k1_ms"], timed["ms"]
        rec.update(k1_ms_per_launch=k1_ms, b4_ms_per_launch=b4_ms,
                   k1_share=rec["k1_launches_per_solve"] * k1_ms / rec["ms_per_solve"],
                   b4_share=rec["b4_launches_per_solve"] * b4_ms / rec["ms_per_solve"])
        emit(dict(phase="sqp", what="FusedSQPSolver: cold solve and re-plans, %s" % model,
                  **rec))
        emit(dict(phase="sqp_launches", model=model, **launches))
        _sqp_checks(rec, launches)
        assert launches[k1_key] == 4 * 72 and launches[b4_key] == 4 * 32, launches
        if model == "face":
            assert launches["fused_rollout_mesh"] == launches["fused_bwd_mesh"] == 0, launches
        out[model] = launches
    return out


def phase_sqp(torch, b4_timed):
    """The gradient-MPC path at the bench_mpc width: `bench.sqp` (a cold
    `FusedSQPSolver.solve` and three re-plans on the 10^3 design, 200 steps
    in 8 segments, 8 knots, 4 iterations), then the plain path on the card
    at a cut depth: one `sqp_optimize` iteration through the eager rollout
    (10 steps, 2 CG iterations) and two `grad_optimize` iterations at 25
    steps."""
    import math
    import time

    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.control import SQPConfig, grad_optimize, sqp_optimize
    from evosoro_tpu_torch.core.types import EnvParams
    from evosoro_tpu_torch.ops import fused_rollout as fr

    fr.FUSED_ROLLOUT_LAUNCHES = 0
    fr.FUSED_ROLLOUT_KNOT_LAUNCHES = 0
    fr.FUSED_BWD_LAUNCHES = 0
    rec = bench.sqp(device="cuda")
    launches = dict(fused_rollout=fr.FUSED_ROLLOUT_LAUNCHES,
                    fused_rollout_with_knots=fr.FUSED_ROLLOUT_KNOT_LAUNCHES,
                    fused_bwd=fr.FUSED_BWD_LAUNCHES)
    k1_ms, b4_ms = b4_timed["k1_ms"], b4_timed["ms"]
    rec.update(k1_ms_per_launch=k1_ms, b4_ms_per_launch=b4_ms,
               k1_share=rec["k1_launches_per_solve"] * k1_ms / rec["ms_per_solve"],
               b4_share=rec["b4_launches_per_solve"] * b4_ms / rec["ms_per_solve"])
    emit(dict(phase="sqp", what="FusedSQPSolver: cold solve and re-plans", **rec))
    emit(dict(phase="sqp_launches", **launches))
    _sqp_checks(rec, launches)

    # the plain path on the card, cut in depth: 10 and 25 steps of the 200
    body, sim, _, dt = bench.mpc_workload(device="cuda")
    env = EnvParams(gravity_enabled=False, floor_enabled=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, info = sqp_optimize(body, sim, env, 10, 8, target=0.4,
                           config=SQPConfig(num_iters=1, cg_iters=2, n_res=8),
                           dt=dt, device="cuda")
    costs = info["cost_trace"].tolist() + [float(info["final_cost"])]
    emit(dict(phase="sqp", what="one sqp_optimize iteration, eager rollout, "
              "forward- and reverse-mode products", steps=10, steps_cut_from=200,
              cg_iters=2, seconds=time.perf_counter() - t0, costs=costs,
              accepted=info["accepted_trace"].tolist()))
    assert all(math.isfinite(c) for c in costs) and costs[-1] <= costs[0], costs
    t0 = time.perf_counter()
    u0 = torch.full((8,) + tuple(body.occ.shape), 0.01, device="cuda")
    _, info = grad_optimize(body, sim, EnvParams(), 25, 8, num_iters=2, lr=1e-3,
                            dt=dt, init_u=u0, device="cuda")
    costs = info["cost_trace"].tolist()
    emit(dict(phase="sqp", what="two grad_optimize iterations, eager rollout",
              steps=25, steps_cut_from=200, seconds=time.perf_counter() - t0,
              costs=costs))
    assert all(math.isfinite(c) for c in costs), costs
    return launches


def phase_evolution(torch, experiments=("basic", "swimming", "growth", "features",
                                         "ballistic", "materials", "swimming_materials")):
    """Two generations each of the basic, swimming and growth experiments and
    of their feature twins (basic with NormDistByVol, the fall-over latch,
    speed windows and a source; growth with ballistic development), of the
    materials experiment and its swimming twin (swimming_materials: the
    facet drag on materials_palette), and of the volume experiment (basic with volume
    effects; each generation records whether a launch was made again for a
    robot short of its stop time), uncut, population 15, through
    `evaluate_all` on the card. Returns the launch counts by experiment."""
    import math

    from evosoro_tpu_torch.bench import evolution
    from evosoro_tpu_torch.ops import fused_rollout as fr

    counters = dict(fused_rollout="FUSED_ROLLOUT_LAUNCHES",
                    fused_rollout_with_contact="FUSED_ROLLOUT_CONTACT_LAUNCHES",
                    fused_rollout_with_knots="FUSED_ROLLOUT_KNOT_LAUNCHES",
                    fused_rollout_fluid="FUSED_ROLLOUT_FLUID_LAUNCHES",
                    fused_rollout_mesh="FUSED_ROLLOUT_MESH_LAUNCHES",
                    fused_rollout_devo="FUSED_ROLLOUT_DEVO_LAUNCHES",
                    fused_rollout_features="FUSED_ROLLOUT_FEATURE_LAUNCHES",
                    fused_rollout_sources="FUSED_ROLLOUT_SOURCE_LAUNCHES",
                    fused_rollout_ballistic="FUSED_ROLLOUT_BALLISTIC_LAUNCHES",
                    fused_rollout_material="FUSED_ROLLOUT_MATERIAL_LAUNCHES",
                    fused_rollout_nonlinear="FUSED_ROLLOUT_NONLINEAR_LAUNCHES",
                    fused_rollout_volume="FUSED_ROLLOUT_VOLUME_LAUNCHES",
                    pair_contact="PAIR_CONTACT_LAUNCHES")
    all_launches = {}
    for experiment in experiments:
        for name in counters.values():
            setattr(fr, name, 0)
        records = evolution(gens=2, pop_size=15, device="cuda", experiment=experiment)
        launches = {k: getattr(fr, name) for k, name in counters.items()}
        for r in records:
            fits = r.pop("fitnesses")
            # invalid and diverged designs get the objective's worst value, -10e6
            valid = [f for f in fits if f > -1e6]
            r.update(phase="evolution", experiment=experiment,
                     n_evaluated_valid=len(valid),
                     all_finite=all(math.isfinite(f) for f in fits))
            emit(r)
            assert r["k1_launches"] > 0, r
            assert r["all_finite"], r
            assert valid, "every design was invalid or diverged"
            if experiment in ("swimming", "swimming_materials"):
                assert r["k1_fluid_launches"] == r["k1_launches"], r
            if experiment in ("growth", "ballistic"):
                assert r["k1_devo_launches"] == r["k1_launches"], r
            # no generation of a feature twin ran the plain version
            if experiment in ("features", "ballistic"):
                assert r["k1_feature_launches"] == r["k1_launches"], r
            if experiment == "ballistic":
                assert r["k1_ballistic_launches"] == r["k1_launches"], r
            # every launch of the custom palette took the material instance,
            # every launch of the volume experiment the volume instance
            if experiment in ("materials", "swimming_materials"):
                assert r["k1_material_launches"] == r["k1_launches"], r
            if experiment == "volume":
                assert r["k1_volume_launches"] == r["k1_launches"], r
        # K2's routine runs inside K1's launches; its own kernel is not on the path
        assert launches["fused_rollout"] > 0, launches
        assert launches["fused_rollout_with_contact"] > 0, launches
        if experiment in ("swimming", "swimming_materials"):  # the facet drag by default
            assert launches["fused_rollout_mesh"] == launches["fused_rollout_fluid"] \
                == launches["fused_rollout"], launches
        elif experiment in ("growth", "ballistic"):
            assert launches["fused_rollout_devo"] == launches["fused_rollout"], launches
        else:
            assert launches["fused_rollout_fluid"] == launches["fused_rollout_devo"] == 0
        features = experiment in ("features", "ballistic")
        assert (launches["fused_rollout_features"] == launches["fused_rollout"]) == features
        assert (launches["fused_rollout_ballistic"] > 0) == (experiment == "ballistic")
        materials = experiment in ("materials", "volume", "swimming_materials")
        assert (launches["fused_rollout_material"] == launches["fused_rollout"]) == materials
        assert (launches["fused_rollout_nonlinear"] > 0) == (
            experiment in ("materials", "swimming_materials"))
        assert (launches["fused_rollout_volume"] == launches["fused_rollout"]) \
            == (experiment == "volume")
        emit(dict(phase="evolution_launches", experiment=experiment, **launches))
        all_launches[experiment] = launches
    return all_launches


# the eager phase (`--eager`): the limited floor's radius on a 4^3 grid (the
# voxel centres lie 0.71, 1.58 or 2.12 lattice units from its centre, so
# the corner columns start off it, none within 0.27 units of its edge), the
# device-parity run's steps, four sources (K1 tracks 3), and the cuts that
# keep the phase near 150 s. The eager step issues some 2500 kernel
# launches from Python and takes 52-58 ms on an H100 whatever the batch
# (4 x 4^3 to 64 x 6^3, contact on or off), so a phase's time is its step
# count: 0.01 s of sim time puts the soft and the stiff (bone) designs of
# the basic genome in one 256-step launch
EAGER_RADIUS = 0.0185
EAGER_PARITY_STEPS = 200
# the full run's cut of the eager phase's parity run, which makes room for
# the parallel phase
EAGER_CUT = dict(parity_steps=EAGER_PARITY_STEPS // 2)
EAGER_SOURCES = [dict(pos=(0.2, 0.03, 0.03), amp=(0.0, 0.05, 0.0), freq=(0.0, 0.5, 0.0),
                      enabled=True),
                 dict(pos=(-0.1, 0.0, 0.02), enabled=True),
                 dict(pos=(0.0, 0.3, 0.0), amp=(0.02, 0.0, 0.0), freq=(1.0, 0.0, 0.0),
                      enabled=True),
                 dict(pos=(0.05, 0.05, 0.1), enabled=False)]
EAGER_GEN = dict(pop_size=8, sim_time=0.01, init_time=0.002)
EAGER_SELECT = dict(pop=16, size=6, sim_time=0.01, init_time=0.002)


def _eager_case(torch, np, device, limited=True, dtype=None):
    """(body, sim, env, dt) of the device-parity run: 4 random 4^3 designs
    of soft materials and muscle (no bone, whose dt is ten times smaller),
    each with its contact tables and its own actuation period, under the
    limited floor (or the whole floor), with 4 sources and speed windows of
    13 trace steps, built on the host in `dtype` (float32 by default) and
    copied to `device`."""
    dtype = dtype or torch.float32
    from evosoro_tpu_torch.core.collision import build_collision_system, stack_collision_systems
    from evosoro_tpu_torch.core.materials import (
        build_body,
        calc_max_dt,
        palette_from_list,
        stack_bodies,
    )
    from evosoro_tpu_torch.core.types import EnvParams, SimParams, evosoro_default_palette
    from evosoro_tpu_torch.envs.sources import make_sources

    rng = np.random.default_rng(23)
    pal = palette_from_list(evosoro_default_palette())
    bodies, systems = [], []
    for _ in range(4):
        s = rng.choice(np.array([0, 1, 3, 4], np.int32), size=(4, 4, 4))
        s[1:3, 1:3, 0] = 3  # a muscle footing under the floor's centre
        bodies.append(build_body(s, pal, phase_offset=rng.uniform(-1, 1, (4, 4, 4)),
                                 dtype=dtype, device="cpu"))
        systems.append(build_collision_system(s, pal.elastic_mod.numpy()[s], 0.01))
    body = stack_bodies(bodies, device=device).replace(
        collision=stack_collision_systems(systems, device=device, dtype=dtype))
    sim = SimParams(init_cm_time=0.0, self_collisions_enabled=True)
    env = EnvParams(temp_amplitude=39.0,
                    temp_period=torch.tensor([0.01, 0.012, 0.015, 0.02], dtype=dtype,
                                             device=device),
                    floor_limited=limited, floor_radius=EAGER_RADIUS,
                    num_trace_steps_in_window=13,
                    sources=make_sources(EAGER_SOURCES).to(device))
    return body, sim, env, calc_max_dt(body) * sim.dt_frac


def _eager_step_ms(torch, device, pop=16, size=6, steps=20, collision=True):
    """(ms a step of the eager evaluator, robots): `pop` valid basic designs
    of size^3, contact on or off, timed over `steps` steps after a short
    warm-up (the evaluator's own clock: its rollout and the copy back)."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.evo import evaluation

    sim, env, p = bench.basic_experiment(pop_size=2 * pop, size=(size,) * 3)
    if not collision:
        sim.self_collisions_enabled = 0
    inds = [i for i in p if i.phenotype.is_valid()][:pop]
    all_fields, all_env, _ = evaluation._batch_fields(sim, env, inds)
    fn, inputs = evaluation._eager_inputs(sim, env, inds[0].genotype.orig_size_xyz,
                                          all_fields, all_env, steps, device)
    fn(*inputs, num_steps=5)
    torch.cuda.synchronize()
    fn(*inputs, num_steps=steps)
    return 1e3 * evaluation.LAST_DISPATCH_TIMING["launch_s"] / steps, len(inds)


def phase_eager(torch, np, card, parity_steps=EAGER_PARITY_STEPS):
    """The eager-step evaluator on the card (JAX's second evaluator path).
    (a) Device parity: `_eager_case` in float64 through
    `core.rollout.rollout` on the card and on the CPU, `parity_steps` (the
    full run cuts EAGER_PARITY_STEPS by half, `EAGER_CUT`)
    actuated steps, every state channel at TOL; the guard, the same run on
    the whole floor, parts from the limited one by more than TOL. In
    float32 the two devices' ulps (other sum orders and libm) grow past TOL
    within 200 steps (friction's static test and the quaternion snap at w
    >= 1 decide on the last bit; on an H100: 5.3e-6 m in pos, 4.3e-5 in
    linmom before the actuation onset), as the two packages' do on the
    CPU (ROADMAP section C), so the eager paths compare in float64; the
    float32 run is held to the chaotic-drift band (DRIFT_BOUND_M on
    positions, a 100-step band) over 50 steps. (b) The eager step's time a
    step at 16 x 6^3 with and without contact. (c) Two generations of the `limited_floor`
    experiment through `evaluate_all` on the card (EAGER_GEN: population
    and sim time cut to fit the phase): every bucket takes the eager step,
    the warning line is printed, and no kernel launches. (d) A generation
    of the basic experiment, inside K1's envelope: every bucket takes K1,
    whose launch counter moves. (e) The kernel-vs-eager selection agreement
    (`evosoro_tpu_torch.selection_agreement`) at EAGER_SELECT, cut from
    JAX's 32 x 10^3 x 5 s: information, not a gate. Returns K1's launches in
    (d) and (e), with contact, for the kernels line."""
    from unittest import mock

    from evosoro_tpu_torch import bench, selection_agreement
    from evosoro_tpu_torch.core.rollout import rollout
    from evosoro_tpu_torch.evo import logging as evo_logging
    from evosoro_tpu_torch.ops import fused_rollout as fr

    def run(device, limited=True, steps=parity_steps, dtype=torch.float64):
        body, sim, env, dt = _eager_case(torch, np, device, limited, dtype)
        res = rollout(body, sim, env, num_steps=steps, dt=dt)
        return {k: getattr(res.final_state, k).cpu() for k in TOL}

    t0 = time.perf_counter()
    card_state = run("cuda")
    card_s = time.perf_counter() - t0
    cpu_state, guard = run("cpu"), run("cuda", limited=False)
    drift = float((run("cuda", steps=50, dtype=torch.float32)["pos"]
                   - run("cpu", steps=50, dtype=torch.float32)["pos"]).abs().max())
    errs, within, guard_out = {}, {}, {}
    for k, (rtol, atol) in TOL.items():
        a, b = card_state[k].double(), cpu_state[k].double()
        errs[k] = float((a - b).abs().max())
        within[k] = bool(torch.allclose(a, b, rtol=rtol, atol=atol))
        g = guard[k].double()
        guard_out[k] = not bool(torch.allclose(g, b, rtol=rtol, atol=atol))
        errs["guard_" + k] = float((g - b).abs().max())
    rec = dict(phase="eager_parity", case="4 x 4^3 in float64, limited floor r=%g m, contact, "
               "4 sources, windows of 13, a period per robot" % EAGER_RADIUS,
               steps=parity_steps, card=card, card_s=card_s, within_tol=within,
               guard_parts=guard_out, actuated_50_steps_float32_pos_drift_m=drift,
               drift_bound_m=DRIFT_BOUND_M, **errs)
    emit(rec)
    assert all(within.values()), rec
    assert guard_out["pos"], rec  # the limited floor moved the voxels
    assert drift <= DRIFT_BOUND_M, rec

    steps = {}
    for coll in (True, False):
        ms, n = _eager_step_ms(torch, "cuda", collision=coll)
        steps["contact" if coll else "no_contact"] = dict(ms_per_step=ms, batch=n)
    emit(dict(phase="eager_step_time", workload="eager evaluator, basic designs, 6^3",
              card=card, **steps))

    counters = ("FUSED_ROLLOUT_LAUNCHES", "FUSED_ROLLOUT_CONTACT_LAUNCHES")

    def zero():
        for name in counters:
            setattr(fr, name, 0)

    lines = []
    real_message = evo_logging.PrintLog.message

    def keep(self, content, timer_name=None):
        lines.append(str(content))
        return real_message(self, content, timer_name)

    zero()
    with mock.patch.object(evo_logging.PrintLog, "message", keep):
        records = bench.evolution(gens=2, device="cuda", experiment="limited_floor",
                                  **EAGER_GEN)
    k1_limited = fr.FUSED_ROLLOUT_LAUNCHES
    for r in records:
        fits = r.pop("fitnesses")
        steps_run = sum(b["num_steps"] for b in r["buckets"])
        r.update(phase="eager_evolution", experiment="limited_floor", card=card,
                 s_per_gen=r["eval_s"], steps_run=steps_run,
                 eager_ms_per_step=1e3 * r["launch_s"] / max(1, steps_run),
                 all_finite=all(np.isfinite(fits)), **EAGER_GEN)
        emit(r)
        assert r["used_fused"] is False and "limited floor" in r["eager_reason"], r
        assert r["all_finite"], r
    assert k1_limited == 0, k1_limited  # the eager step launches no kernel
    assert any(line.startswith("WARNING: generation leaving the fused K1 path")
               and "limited floor" in line for line in lines)

    zero()
    records = bench.evolution(gens=1, device="cuda", experiment="basic", **EAGER_GEN)
    k1_inside = {name: getattr(fr, name) for name in counters}
    for r in records:
        r.pop("fitnesses")
        emit(dict(r, phase="eager_phase_k1_generation", card=card))
        assert r["used_fused"] is True and r["eager_reason"] is None, r
    assert k1_inside["FUSED_ROLLOUT_LAUNCHES"] > 0, k1_inside

    zero()
    sel = selection_agreement.agreement(device="cuda", **EAGER_SELECT)
    k1_select = {name: getattr(fr, name) for name in counters}
    sel.update(phase="eager_selection_agreement", card=card,
               cut="population %d of %d^3 for %g s of sim time from %g s, where the JAX "
               "record (SELECTAGREE.json) has 32 of 10^3 for 5 s from 0.4 s" % (
                   EAGER_SELECT["pop"], EAGER_SELECT["size"], EAGER_SELECT["sim_time"],
                   EAGER_SELECT["init_time"]))
    emit(sel)
    assert k1_select["FUSED_ROLLOUT_LAUNCHES"] > 0, k1_select
    return dict(
        fused_rollout=k1_inside["FUSED_ROLLOUT_LAUNCHES"] + k1_select["FUSED_ROLLOUT_LAUNCHES"],
        fused_rollout_with_contact=k1_inside["FUSED_ROLLOUT_CONTACT_LAUNCHES"]
        + k1_select["FUSED_ROLLOUT_CONTACT_LAUNCHES"])


# the multi-device phase (`--parallel`): the basic generation as
# `phase_eager`'s (EAGER_SELECT's size, cut to 0.01 s), the spatial body of
# tests/test_spatial_sharding.py
PARALLEL_GEN = dict(pop_size=16, size=6, sim_time=0.01, init_time=0.002)
PARALLEL_SPATIAL_STEPS = 20
# the full run's cut of it
PARALLEL_CUT = dict(spatial_steps=10, sqp_steps=4)


def _spatial_case(torch, np, device):
    """tests/test_spatial_sharding.py's `_make`: 16 x 5 x 4, seed 0, a
    connected spine, in float64; actuated from the first step (its CoM
    captured there), so that the distance the fitness measures is motion:
    with JAX's capture at 1 ms, 20 steps move the CoM by 2.6e-9 m, where
    the sums' rounding is 1e-8 of it."""
    from evosoro_tpu_torch.core import (SimParams, build_body, calc_max_dt,
                                        evosoro_default_palette, palette_from_list)

    X, Y, Z = 16, 5, 4
    rng = np.random.default_rng(0)
    structure = rng.integers(0, 5, size=(X, Y, Z)).astype(np.int32)
    structure[:, Y // 2, 0] = 3
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=rng.uniform(-1, 1, size=(X, Y, Z)),
                      dtype=torch.float64, device=device)
    sim = SimParams(init_cm_time=0.0)
    return body, sim, float(calc_max_dt(body)) * sim.dt_frac


def phase_parallel(torch, np, card, spatial_steps=PARALLEL_SPATIAL_STEPS, sqp_steps=6):
    """The multi-device paths on the one card, a mesh naming it more than
    once (`parallel.mesh`): (a) `sharded_fused_rollout` over 4 entries, 64 x
    4^3 x 25 steps with contact, bit for bit against one launch of the same
    batch (K1's results for a robot do not depend on the rest of its
    launch), and K1 against its plain version at that shape; (b)
    `evaluate_all(devices=[card] * 2)` on one basic generation, fitness bit
    for bit against the one-device generation; (c) a fused CEM solve and
    (d) a 4-start SQP multistart over two entries, equal to the unsharded
    solves; (e) `spatial_rollout` of the 16 x 5 x 4 body over four slabs in
    float64, interiors against the one-slab eager rollout at rtol 1e-12 and
    the CoM fitness at rtol 1e-8 (tests/test_spatial_sharding.py:46-62);
    (f) two processes on the card through `distributed_init(backend="gloo")`
    (NCCL refuses two ranks on one GPU), splitting the generation and a
    two-slab spatial rollout and all-gathering them, equal to one process
    (`parallel.ranks`; a rank that fails fails the phase). K1's counters are
    zeroed before each sharded run and read after it. Returns K1's launches
    there and the K1-vs-plain record."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.control.shooting import CEMConfig, cem_optimize_fused
    from evosoro_tpu_torch.control.sqp import SQPConfig, sqp_optimize_multistart
    from evosoro_tpu_torch.core import (EnvParams, SimParams, build_body, calc_max_dt,
                                        evosoro_default_palette, init_state,
                                        palette_from_list, rollout)
    from evosoro_tpu_torch.core.collision import attach_collision_system
    from evosoro_tpu_torch.evo import evaluation
    from evosoro_tpu_torch.evo.logging import PrintLog
    from evosoro_tpu_torch.ops import fused_rollout as fr
    from evosoro_tpu_torch.parallel import mesh as pm
    from evosoro_tpu_torch.parallel import ranks
    from evosoro_tpu_torch.parallel.spatial import spatial_rollout

    dev = "cuda:0"
    counters = ("FUSED_ROLLOUT_LAUNCHES", "FUSED_ROLLOUT_CONTACT_LAUNCHES")
    launches = dict.fromkeys(counters, 0)

    def sharded(fn):
        """fn() with K1's counters zeroed before and read after, its
        launches added to the phase's; (result, launches, seconds)."""
        for name in counters:
            setattr(fr, name, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {name: getattr(fr, name) for name in counters}
        for name in counters:
            launches[name] += got[name]
        return out, got["FUSED_ROLLOUT_LAUNCHES"], secs

    # (a) K1 over four entries of one card
    _, body = bench.bench_body(n=4, device=dev)
    body = attach_collision_system(body, 2.0)
    sim, env = SimParams(init_cm_time=0.0, self_collisions_enabled=True), EnvParams()
    dt = float(calc_max_dt(body)) * sim.dt_frac
    g = torch.Generator(device=dev).manual_seed(3)
    state = pm.tree_map(lambda t: t.expand((64,) + t.shape).clone(), init_state(body))
    state = state.replace(pos=state.pos + 1e-4 * torch.randn(
        state.pos.shape, generator=g, device=dev, dtype=state.pos.dtype))
    # the one launch it is held against is a reference, not counted
    one = fr.fused_rollout(state, body, sim, env, 25, dt)
    (sh_state, sh_stats), n_a, sh_s = sharded(lambda: pm.sharded_fused_rollout(
        state, body, sim, env, 25, dt, [dev] * 4))
    equal = []
    pm.tree_map(lambda x, y: equal.append(bool(torch.equal(x, y))),
                (sh_state, sh_stats), one)
    rec = dict(phase="parallel_sharded_k1", card=card, workload="bench 4^3 x 64, 25 steps, "
               "contact on, 4 entries of one card", k1_launches=n_a, bit_equal=all(equal),
               sharded_s=sh_s)
    emit(rec)
    assert rec["bit_equal"] and n_a == 4, rec
    args, kw, _ = bench.packed_workload(64, n=4, collision=True, device=dev)
    k1 = _k1_cases(torch, fr, "parallel phase: bench 4^3 x 64", args, kw, 64, True, (25,),
                   time_at=25, phase="parallel_k1_vs_plain")[0]
    # the same batch as four launches of 16 robots on the card's one stream
    quarters = [tuple(t[i * 16:(i + 1) * 16].contiguous() if t.shape[0] == 64 else t
                      for t in args[:3]) + (args[3],) for i in range(4)]
    emit(dict(phase="parallel_k1_shard_time", card=card, ms_one_launch_64=k1["ms"],
              ms_four_launches_16=_event_ms(torch, lambda: [
                  fr.fused_call(*q, num_steps=25, **kw) for q in quarters], 5)))

    # (b) one generation over two entries against one device
    fits = {}
    for key, kw2 in (("one", dict(device=dev)), ("mesh", dict(devices=[dev] * 2))):
        gsim, genv, pop = bench.basic_experiment(
            pop_size=PARALLEL_GEN["pop_size"], sim_time=PARALLEL_GEN["sim_time"],
            init_time=PARALLEL_GEN["init_time"], size=(PARALLEL_GEN["size"],) * 3)
        run = (lambda: evaluation.evaluate_all(gsim, genv, pop, print_log=PrintLog(), **kw2))
        _, n_k1, secs = sharded(run) if key == "mesh" else (run(), 0, 0.0)
        fits[key] = np.array([ind.fitness for ind in pop])
        if key == "mesh":
            rec = dict(phase="parallel_generation", card=card, **PARALLEL_GEN,
                       n_shards=evaluation.LAST_DISPATCH_TIMING["n_shards"], k1_launches=n_k1,
                       buckets=evaluation.LAST_DISPATCH_TIMING["buckets"], s_per_gen=secs)
    rec.update(fitness_bit_equal=bool(np.array_equal(fits["one"], fits["mesh"])),
               best=float(fits["one"].max()))
    emit(rec)
    assert rec["fitness_bit_equal"] and rec["n_shards"] == 2 and rec["k1_launches"] > 0, rec

    # (c) the fused CEM solve over two entries
    _, cbody = bench.bench_body(n=6, device=dev)
    csim = SimParams(init_cm_time=0.0)
    cem = {}
    for key, mesh in (("one", None), ("mesh", [dev] * 2)):
        def solve(mesh=mesh):
            return cem_optimize_fused(torch.Generator(device=dev).manual_seed(0), cbody, csim,
                                      EnvParams(), 50, 4, CEMConfig(num_iters=3, pop_size=64),
                                      device=dev, mesh=mesh)
        cem[key] = sharded(solve) if mesh else (solve(), 0, 0.0)
    (u1, i1), (u2, i2) = cem["one"][0], cem["mesh"][0]
    rec = dict(phase="parallel_cem", card=card, workload="bench 6^3, 64 candidates, 4 knots, "
               "50 steps, 3 iterations, 2 entries", k1_launches=cem["mesh"][1],
               best_u_bit_equal=bool(torch.equal(u1, u2)),
               best_cost=i2["best_cost"], best_cost_equal=i1["best_cost"] == i2["best_cost"],
               solve_s=cem["mesh"][2])
    emit(rec)
    assert rec["best_u_bit_equal"] and rec["best_cost_equal"] and rec["k1_launches"] == 6, rec

    # (d) the SQP multistart, four starts over two entries
    rng = np.random.default_rng(5)
    sbody = build_body(rng.integers(1, 5, size=(3, 3, 3)).astype(np.int32),
                       palette_from_list(evosoro_default_palette()),
                       phase_offset=rng.uniform(-1, 1, size=(3, 3, 3)), device=dev)
    cfg = SQPConfig(num_iters=1, cg_iters=2, n_res=2, w_reg=1e-2)
    sqp = {}
    for key, mesh in (("one", None), ("mesh", [dev] * 2)):
        t0 = time.perf_counter()
        sqp[key] = sqp_optimize_multistart(
            torch.Generator(device=dev).manual_seed(0), sbody, SimParams(init_cm_time=0.0),
            EnvParams(), sqp_steps, 2, n_starts=4, target=0.05, config=cfg, device=dev,
            mesh=mesh)
        torch.cuda.synchronize()
        sqp[key + "_s"] = time.perf_counter() - t0
    rec = dict(phase="parallel_sqp_multistart", card=card, workload="3^3, 4 starts, %d steps, "
               "2 knots, 1 iteration, 2 entries" % sqp_steps,
               u_bit_equal=bool(torch.equal(sqp["one"][0], sqp["mesh"][0])),
               costs_equal=bool(torch.equal(sqp["one"][1]["all_costs"],
                                            sqp["mesh"][1]["all_costs"])),
               best_start=int(sqp["mesh"][1]["best_start"]), solve_s=sqp["mesh_s"])
    emit(rec)
    assert rec["u_bit_equal"] and rec["costs_equal"], rec

    # (e) one robot's lattice over four slabs, in float64
    sbody, ssim, sdt = _spatial_case(torch, np, dev)
    t0 = time.perf_counter()
    res = spatial_rollout(sbody, ssim, EnvParams(), spatial_steps, sdt, [dev] * 4)
    torch.cuda.synchronize()
    spatial_s = time.perf_counter() - t0
    ref = rollout(sbody, ssim, EnvParams(), num_steps=spatial_steps, dt=sdt)
    d = (res.final_state.pos - ref.final_state.pos).abs()
    within = bool((d <= 1e-15 + 1e-12 * ref.final_state.pos.abs()).all())
    qd = (res.final_state.quat - ref.final_state.quat).abs()
    q_within = bool((qd <= 1e-15 + 1e-12 * ref.final_state.quat.abs()).all())
    fd = abs(float(res.final_dist) - float(ref.final_dist))
    rec = dict(phase="parallel_spatial", card=card, workload="16 x 5 x 4, float64, 4 slabs",
               steps=spatial_steps, pos_err=float(d.max()), quat_err=float(qd.max()),
               pos_within_rtol_1e_12=within, quat_within_rtol_1e_12=q_within,
               final_dist=float(res.final_dist), final_dist_err=fd,
               fitness_within_rtol_1e_8=fd <= 1e-8 * abs(float(ref.final_dist)) + 1e-16,
               spatial_s=spatial_s)
    emit(rec)
    assert within and q_within and rec["fitness_within_rtol_1e_8"], rec
    assert bool(res.diverged) == bool(ref.diverged), rec

    # (f) two processes on the one card, gloo
    t0 = time.perf_counter()
    got = ranks.run_ranks(world=2, device=dev, backend="gloo", timeout=300,
                          generation=PARALLEL_GEN)
    ranks_s = time.perf_counter() - t0
    one = ranks.workload(dev, PARALLEL_GEN, slabs=2)
    rec = dict(phase="parallel_two_processes", card=card, backend="gloo", world=2,
               generation=PARALLEL_GEN, n_shards=[r["n_shards"] for r in got],
               fitness_equal=all(r["fitness"] == one["fitness"] for r in got),
               spatial_equal=all(r["spatial_pos"] == one["spatial_pos"] for r in got),
               ranks_s=ranks_s)
    emit(rec)
    assert rec["fitness_equal"] and rec["spatial_equal"] and rec["n_shards"] == [2, 2], rec
    return dict(fused_rollout=launches["FUSED_ROLLOUT_LAUNCHES"],
                fused_rollout_with_contact=launches["FUSED_ROLLOUT_CONTACT_LAUNCHES"],
                k1=k1)


def phase_throughput(torch, card):
    from evosoro_tpu_torch.bench import throughput

    recs = dict(
        k1=throughput(batch=1024, steps=200, groups=4, reps=3),
        k1_20=throughput(batch=1024, steps=20, groups=4, reps=3),
        plain_20=throughput(batch=1024, steps=20, plain=True, groups=1, reps=1),
        k1_coll=throughput(batch=1024, steps=20, collision=True, groups=2, reps=2),
        plain_coll=throughput(batch=1024, steps=5, collision=True, plain=True,
                              groups=1, reps=1),
        k1_fluid_mesh=throughput(batch=1024, steps=200, fluid="mesh", groups=3, reps=2),
        k1_fluid_face=throughput(batch=1024, steps=200, fluid="face", groups=3, reps=2),
    )
    for r in recs.values():
        emit(dict(phase="throughput", card=card, **r))
    return recs


def phase_step(torch, np, alone=False, against=None):
    """K1's own step (B1, csrc/k1_step.cuh: bond items over more warps, the
    state resident in shared memory, sums in the old order) and its knot
    launch (B3). (a) K1 against its plain version over 25 steps: the
    evolution bodies, whose state stays resident (the evaluator batch
    16 x 6^3 with contact at 512 threads, the materials evaluator batch
    with contact, plasticity and the clamp at 384), and a cut batch (8
    robots) of each 10^3 instance the times below run: the bench design on
    land, on `materials_palette` with plasticity and the clamp, with volume
    effects, in water with each drag model, the cold solve's launch with 8
    knots, and the SQP solve's segmented launch at seg_base 75. (b)
    The times: one 6^3 robot a step with and without contact (2000 steps),
    the evaluator batch 16 x 6^3 x 25 with contact, with and without the
    features, the materials and volume batches 16 x 6^3 x 25 with contact,
    1024 x 10^3 x 20 with contact, 1024 x 10^3 x 200 in
    the land, material, volume, face-drag and facet-drag instances, B3's
    launch 128 x 10^3 x 200 with 8 knots (a cold CEM solve's) and the SQP
    solve's K1 segment (8 x 10^3 x 25 at seg_base 75, 8 knots), each
    beside its bound, its block size and whether its state stayed resident
    (`fr.k1_launch_shape`). `alone` (`--step`) adds, with the counters
    zeroed before and read after, two generations of the basic experiment
    and a cold CEM solve, which the full run drives in `phase_evolution`
    and `phase_mpc`. `against` (`--step --against CHECKOUT`) times every
    workload of (b) and the two generations in turns with another
    checkout's K1 (`buildcmp.in_turns`: parent, this, and where the state
    stays resident this with it kept in device memory, the mapping alone;
    then back), each arm's times in `turns`, and asserts that every arm
    gives the same bits. Returns the records."""
    import math

    from evosoro_tpu_torch import bench, roofline
    from evosoro_tpu_torch.buildcmp import sqp_k1_launch
    from evosoro_tpu_torch.ops import fused_rollout as fr

    res = dict(cases=[], times=[])
    arms = None
    if against:
        from evosoro_tpu_torch.buildcmp import in_turns, launchers

        calls = launchers(against)
        arms = {"parent": calls["other"], "this": calls["this"]}

    def shape_of(kw, table=None):
        n_surf = table.shape[-1] if kw["flags"].get("collision_compact") else None
        return fr.k1_launch_shape(kw["grid_shape"], kw["flags"], kw["scalars"], n_surf)

    def cut(args, kw, B=8):
        a = tuple(t[:B].contiguous() if t is not None and t.shape[0] > 1 else t
                  for t in args)
        k = dict(kw)
        if k.get("control_packed") is not None:
            k["control_packed"] = k["control_packed"][:B].contiguous()
        return a, k

    # (a) each instance against its plain version
    land = bench.packed_workload(1024, device="cuda")[:2]
    mats = bench.packed_workload(1024, device="cuda", materials=True)[:2]
    vol = bench.packed_workload(1024, device="cuda", volume=True)[:2]
    face = bench.packed_workload(1024, device="cuda", fluid="face")[:2]
    mesh = bench.packed_workload(1024, device="cuda", fluid="mesh")[:2]
    runner_body, sim, env, dt = bench.mpc_workload(device="cuda")
    runner = fr.FusedBatchRunner(runner_body, sim, env, batch=128, num_steps=200,
                                 num_knots=8, dt=dt)
    knots = ((runner.state_packed, runner.body_packed, runner.stats, None),
             dict(runner.call_kwargs, control_packed=_controls(torch, np, 128, 8, 1000, 5)))
    knots[1].pop("num_steps")
    sqp_args, sqp_kw = sqp_k1_launch()
    st75, ss75 = fr.fused_call(*sqp_args, num_steps=75, **sqp_kw)
    segment = ((st75, sqp_args[1], ss75, None), dict(sqp_kw, seg_base=75))
    mat_tol = _strictest("nonlinear", "plasticity", "max_vel")
    ev, ev_kw = bench.evaluator_workload(collision=True, device="cuda")
    # the evolution bodies: state resident, 512 threads, and 384 with the
    # pair pass and the material options
    for label, (a, k), tol in (
            ("evaluator batch 16 x 6^3, contact on", (ev, ev_kw), TOL),
            ("materials evaluator batch 16 x 6^3, contact on",
             bench.materials_workload(device="cuda"), mat_tol)):
        res["cases"].append(_k1_cases(torch, fr, label, a, k, a[0].shape[0], True, (25,),
                                      phase="step_vs_plain", tol=tol, **shape_of(k, a[3]))[0])
    for label, (a, k), tol, extra in (
            ("bench 10^3, land", land, TOL, {}),
            ("bench 10^3, materials", mats, mat_tol, {}),
            ("bench 10^3, volume effects", vol, VOL_TOL, {}),
            ("bench 10^3 in its 11^3 shell, face drag", face, TOL, {}),
            ("bench 10^3 in its 11^3 shell, facet drag", mesh, MESH_TOL, {}),
            ("MPC solve launch 10^3", knots, TOL, dict(knots=8)),
            ("SQP segment 10^3 at seg_base 75", segment, TOL, dict(knots=8))):
        a8, k8 = cut(a, k)
        rec = _k1_cases(torch, fr, label, a8, k8, 8, False, (25,), phase="step_vs_plain",
                        tol=tol, need_small=tol is not MESH_TOL, **extra, **shape_of(k8))[0]
        res["cases"].append(rec)

    # (b) the times, each beside its bound
    def timed(label, a, k, steps, groups=3, reps=2, per_step=False, **extra):
        def run():
            return fr.fused_call(*a, num_steps=steps, **k)

        shape = shape_of(k, a[3])
        if arms:
            arm = dict(arms, **({"mapping_alone": (calls["this"], False)}
                                if shape["resident"] else {}))
            turns, same = in_turns(arm, lambda: bench.time_call(run, groups, reps), run, 2)
            assert same, (label, turns)
            ms = min(turns["this"])
            extra = dict(extra, turns=turns, parent_ms=min(turns["parent"]),
                         bit_equal_across_arms=same)
        else:
            ms = bench.time_call(run, groups, reps)
        _, st_out = run()
        ss = k.get("ss_packed")
        rec = dict(phase="step_time", workload=label, batch=a[0].shape[0], steps=steps,
                   ms=ms, contact=a[3] is not None, **shape, **extra,
                   **roofline.bound(*roofline.launch_work(
                       *a, st_out, k.get("control_packed"), flags=k["flags"],
                       grid_shape=k["grid_shape"], scalars=k["scalars"],
                       n_pts=0 if ss is None else (ss.shape[1] - 3) // 2,
                       num_steps=steps)))
        if per_step:
            rec["us_a_step"] = 1e3 * ms / steps
        rec["share_of_bound"] = rec["bound_ms"] / ms
        emit(rec)
        res["times"].append(rec)
        return rec

    ev_nc, ev_nc_kw = bench.evaluator_workload(collision=False, device="cuda")
    one = tuple(t[:1].contiguous() if t is not None else None for t in ev)
    one_nc = tuple(t[:1].contiguous() if t is not None else None for t in ev_nc)
    timed("one robot of the evaluator batch, 6^3, contact on", one, ev_kw, 2000,
          per_step=True)
    timed("one robot of the evaluator batch, 6^3, contact off", one_nc, ev_nc_kw, 2000,
          per_step=True)
    res["evaluator"] = timed("evaluator batch 16 x 6^3, contact on", ev, ev_kw, 25)
    res["evaluator"]["plain_ms"] = _event_ms(
        torch, lambda: fr.fused_rollout_plain(*ev, num_steps=25, **ev_kw), 1, warm=False)
    # the other evolution batches with contact: 384 threads, resident
    timed("evaluator batch 16 x 6^3, contact on, features", ev,
          bench.with_features(ev_kw, ev[2], n_win=4, n_src=1), 25)
    timed("materials batch 16 x 6^3, contact on", *bench.materials_workload(device="cuda"), 25)
    timed("volume batch 16 x 6^3, contact on", *bench.volume_workload(device="cuda"), 25)
    timed("bench 1024 x 10^3 x 20, contact on",
          *bench.packed_workload(1024, collision=True, device="cuda")[:2], 20)
    for key, label, (a, k) in (("land", "land", land), ("materials", "materials", mats),
                               ("volume", "volume effects", vol),
                               ("face", "face drag, 11^3 shell", face),
                               ("mesh", "facet drag, 11^3 shell", mesh)):
        res[key] = timed("bench 1024 x 10^3 x 200, " + label, a, k, 200, 3, 3)
    res["knots"] = timed("MPC solve launch 128 x 10^3 x 200, 8 knots", *knots, 200, 3, 3,
                         knots=8)
    res["knots"]["plain_ms"] = _event_ms(
        torch, lambda: fr.fused_rollout_plain(*knots[0], num_steps=200, **knots[1]), 1,
        warm=False)
    res["segment"] = timed("SQP segment 8 x 10^3 x 25 at seg_base 75, 8 knots", *segment,
                           25, 3, 5, knots=8)
    res["launches"] = None
    if alone:
        from evosoro_tpu_torch.bench import evolution
        from evosoro_tpu_torch.control import CEMConfig, cem_optimize_fused

        if arms:  # each generation's seconds, in turns
            turns, _ = in_turns(arms, lambda: [r["eval_s"] for r in evolution(
                gens=2, pop_size=15, device="cuda", experiment="basic")], tuple, 1)
            emit(dict(phase="step_evolution_turns", experiment="basic", eval_s=turns))
        fr.FUSED_ROLLOUT_LAUNCHES = 0
        fr.FUSED_ROLLOUT_CONTACT_LAUNCHES = 0
        fr.FUSED_ROLLOUT_KNOT_LAUNCHES = 0
        for r in evolution(gens=2, pop_size=15, device="cuda", experiment="basic"):
            fits = r.pop("fitnesses")
            r.update(phase="step_evolution", experiment="basic",
                     all_finite=all(math.isfinite(f) for f in fits))
            emit(r)
            assert r["all_finite"] and r["k1_launches"] > 0, r
        evo = dict(fused_rollout=fr.FUSED_ROLLOUT_LAUNCHES,
                   fused_rollout_with_contact=fr.FUSED_ROLLOUT_CONTACT_LAUNCHES)
        gen = torch.Generator(device="cuda").manual_seed(0)
        before = fr.FUSED_ROLLOUT_LAUNCHES
        u, info = cem_optimize_fused(gen, runner_body, sim, env, num_steps=200, num_knots=8,
                                     config=CEMConfig(), dt=dt, device="cuda")
        solve = dict(fused_rollout=fr.FUSED_ROLLOUT_LAUNCHES - before,
                     fused_rollout_with_knots=fr.FUSED_ROLLOUT_KNOT_LAUNCHES,
                     best_cost=float(info["best_cost"]),
                     all_finite=bool(torch.isfinite(u).all()))
        emit(dict(phase="step_launches", evolution=evo, cem_solve=solve))
        assert evo["fused_rollout"] > 0 and evo["fused_rollout_with_contact"] > 0, evo
        assert solve["fused_rollout_with_knots"] == solve["fused_rollout"] > 0, solve
        assert solve["all_finite"] and math.isfinite(solve["best_cost"]), solve
        res["launches"] = dict(evolution=evo, cem_solve=solve)
    return res


def _step_rows(step, bound_keys, k1_launches, knot_launches, k1_timed=None, knot_timed=None):
    """The kernels line's rows of K1's own step (B1) and of its knot launch
    (B3) from `phase_step`: the launches counted on the main paths, the
    largest error against the plain version, the times of this slice's
    workloads with their block sizes and resident flags beside their
    bounds. The full run passes its own timed records of the evaluator
    batch (`phase_k1`) and of the cold solve's launch (`phase_mpc`)."""
    k1_timed = k1_timed or step["evaluator"]
    knot_timed = knot_timed or step["knots"]
    cases = step["cases"]
    return [
        dict(name="fused_rollout (K1)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/k1_step.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:777",
             launches=k1_launches, **bound_keys(k1_timed),
             max_abs_err=max(r["pos"] for r in cases if "knots" not in r),
             err_of=("pos (m) against the plain version over 25 steps: the 16 x 6^3 "
                     "evaluator and materials batches with contact, and 8 robots of the "
                     "bench 10^3 design on land, materials, volume effects, face and facet "
                     "drag"),
             ms=k1_timed["ms"], plain_ms=k1_timed["plain_ms"],
             ms_of="evaluator batch 16 x 6^3, 25 steps, contact on",
             **_step_extras(step)[0]),
        dict(name="K1 control knots + segments (B3)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/k1_step.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:1710",
             launches=knot_launches, **bound_keys(knot_timed),
             max_abs_err=max(r["pos"] for r in cases if "knots" in r),
             err_of=("pos (m) against the plain version: 8 robots x 25 steps of the cold "
                     "solve's launch and of the SQP segment at seg_base 75, 8 knots"),
             ms=knot_timed["ms"], plain_ms=knot_timed["plain_ms"],
             ms_of="one launch of a cold solve: 128 x 10^3, 8 knots, 200 steps",
             **_step_extras(step)[1]),
    ]


def _step_extras(step):
    """The keys `phase_step` adds to the B1 and B3 rows: every workload's
    time with its bound, share, block size and resident flag, and the
    ceiling of the share under -fmad=false (a multiply and an add issue
    apart, where the bound counts fused multiply-adds)."""
    def brief(rec):
        return dict(ms=rec["ms"], bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                    share_of_bound=rec["share_of_bound"], threads=rec["threads"],
                    resident=rec["resident"], instance=rec["instance"])

    ceiling = "50 % of the bound (-fmad=false)"
    return (dict(step_times={r["workload"]: brief(r) for r in step["times"]},
                 ceiling_of_share=ceiling),
            dict(threads=step["knots"]["threads"], resident=step["knots"]["resident"],
                 segment_ms=step["segment"]["ms"], segment_threads=step["segment"]["threads"],
                 ceiling_of_share=ceiling))


def _material_digests(torch):
    """The digests of K1's material instance without volume effects, kernel
    only: the materials evaluator batch with plasticity and the clamp (100
    steps, and with the features), the cantilever read with `load_vxa` (200
    steps) and the bench design in equilibrium mode (8 x 10^3, 100 steps).
    Uses only names the port has had since the material instance came."""
    import tempfile

    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.ops import fused_rollout as fr

    args, kw = bench.materials_workload(device="cuda")
    cases = [("materials evaluator batch", args, kw, 100),
             ("materials evaluator batch, features", args,
              bench.with_features(kw, args[2], n_win=4, n_src=1), 100)]
    with tempfile.TemporaryDirectory() as tmp:
        a, k, _ = bench.cantilever_workload(os.path.join(tmp, "cantilever.vxa"), batch=2,
                                            device="cuda")
    cases.append(("cantilever 10^3", a, k, 200))
    a, k, _ = bench.packed_workload(8, device="cuda", equilibrium=True)
    cases.append(("bench 8 x 10^3, equilibrium mode", a, k, 100))
    for label, a, k, steps in cases:
        out, st = fr.fused_call(*a, num_steps=steps, **k)
        _digest("k1_material_instance/%s/steps=%d" % (label, steps), out, st)


def phase_land(torch, np, card):
    """The land path alone, for holding two commits against each other on one
    card: K1 (as packed and staggered, with knots, in segments) and B4
    against their plain versions as in the full run, the digest of every
    kernel output, and the times of K1 on 1024 x 10^3 x 200 steps (best of 4
    groups of 3) and of the SQP solver's K1 segment and B4 launch (8 x 10^3 x
    25 steps, 8 knots; mean of 5); then the material instance without volume
    effects: the digests of `_material_digests` and its time on 1024 x 10^3
    x 200 steps. Ends with one JSON object of all of it."""
    from evosoro_tpu_torch.bench import throughput

    phase_k1(torch, timed=False)
    phase_k1_knots(torch, np)
    phase_k1_segmented(torch, np)
    b4_timed = next(r for r in phase_b4(torch, np) if "ms" in r)
    k1_ms = [throughput(batch=1024, steps=200, groups=4, reps=3)["ms"] for _ in range(2)]
    land = dict(DIGESTS)
    DIGESTS.clear()
    _material_digests(torch)
    mat_ms = [throughput(batch=1024, steps=200, materials=True, groups=4, reps=3)["ms"]
              for _ in range(2)]
    emit(dict(land=dict(card=card, digests=land, k1_1024x10_3x200_ms=k1_ms,
                        k1_segment_ms=b4_timed["k1_ms"], b4_segment_ms=b4_timed["ms"],
                        material_digests=DIGESTS,
                        materials_1024x10_3x200_ms=mat_ms)))


def _k2_row(k2, pair, bound_keys, launches, k1_contact_launches):
    """The kernels line's row of the dense pair pass: K2's own launch, the
    K1 launches that ran the routine, and its tile counts."""
    return dict(name="pair_contact_forces (K2)", route="cuda",
                source="evosoro_tpu_torch/ops/csrc/pair_contact.cu",
                replaces="evosoro_tpu/ops/fused_rollout.py:672",
                launches=launches, runs_inside="fused_rollout (K1)",
                **bound_keys(k2),
                k1_launches_with_contact=k1_contact_launches,
                max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
                err_of="force (N), own launch, %s %s, table %s"
                % (k2["workload"], k2["shape"], k2["table_shape"]),
                ms_of="own launch, same input",
                tiles_evaluated_of_total={r["workload"]: [r["tiles_evaluated"],
                                                          r["tiles_total"]]
                                          for r in pair["tiles"]},
                guard_ratio=pair["guard"]["guard_ratio"])


def _b4_rows(b4, b4_var, sqp_launches, var_launches, bound_keys):
    """The kernels line's rows of B4: the land instance and the fluid and
    development instances, each with its launches in the SQP phases."""
    b4_timed = next(r for r in b4 if "ms" in r)
    rows = [dict(name="fused_rollout_bwd (B4)", route="cuda",
                 source="evosoro_tpu_torch/ops/csrc/fused_rollout_bwd.cu",
                 replaces="evosoro_tpu/ops/fused_rollout.py:2745",
                 launches=sqp_launches["fused_bwd"],
                 **bound_keys(b4_timed),
                 max_abs_err=max(r["max_abs_err"] for r in b4),
                 worst_rel_err=max(r["worst_rel_err"] for r in b4),
                 err_of=("cotangent of the controls, against autograd through the "
                         "plain version: the SQP launch 8 x 10^3 x 25 steps, 8 knots, "
                         "from rest and 75 steps in, floor and gravity off and on; "
                         "4 x 6^3 with a body per robot; a zero cotangent. "
                         "worst_rel_err: every channel group of both cotangents over "
                         "the group's largest plain value"),
                 ms=b4_timed["ms"], plain_ms=b4_timed["plain_ms"],
                 launch_shape=b4_timed["launch_shape"],
                 ms_of="one launch of a solve: 8 x 10^3, 25 steps at seg_base 75, 8 knots")]
    for model, _, name, _, b4_key in B4_VARIANTS:
        recs = b4_var[model]
        timed = next(r for r in recs if "ms" in r)
        guards = {k: v for r in recs for k, v in r.items()
                  if k.startswith("guard_") and k not in ("guard_one_step_short",
                                                          "guard_neighbouring_knot")}
        rows.append(dict(
            name="fused_rollout_bwd (B4), %s" % name, route="cuda",
            source="evosoro_tpu_torch/ops/csrc/fused_rollout_bwd.cu",
            replaces="evosoro_tpu/ops/fused_rollout.py:2745",
            launches=var_launches[model][b4_key],
            launches_of="bench.sqp, %s: a cold solve and 3 re-plans" % name,
            **bound_keys(timed),
            max_abs_err=max(r["max_abs_err"] for r in recs),
            worst_rel_err=max(r["worst_rel_err"] for r in recs), guards=guards,
            err_of=("cotangent of the controls, against autograd through the plain "
                    "version: the SQP launch %s x 25 steps, 8 knots, from rest, 75 steps "
                    "in, and the guards' launch; worst_rel_err as the "
                    "land row"
                    % recs[0]["workload"].split(", ")[0][len("SQP launch "):]),
            ms=timed["ms"], plain_ms=timed["plain_ms"], launch_shape=timed["launch_shape"],
            ms_of="one launch of a solve: %s" % timed["workload"]))
    return rows


# the 12^3 basic experiment's depth: its sim time cut from 5 s (and the
# CoM capture from 1 s), so that two generations with contact take well
# under a minute
BIG_SIM_TIME, BIG_INIT_TIME = 0.5, 0.1


def _device_instances(fr):
    """A context in which K1 and B4 launch their device-memory instances at
    any body size (`k1_instance` says "device")."""
    from unittest import mock

    return mock.patch.object(fr, "k1_instance", lambda *a, **k: "device")


def _keeping_launch(torch, fr, keep):
    """A context in which `fr.fused_call` runs as before and a copy of the
    inputs of its first call whose keywords satisfy `keep` is kept: yields
    a list that then holds (args, keywords without num_steps, num_steps)."""
    import contextlib

    def copy(t):
        return t.clone() if torch.is_tensor(t) else t

    @contextlib.contextmanager
    def context():
        kept, real = [], fr.fused_call

        def call(*a, **k):
            if not kept and keep(k):
                kept.append((tuple(copy(t) for t in a),
                             {key: copy(v) for key, v in k.items() if key != "num_steps"},
                             k["num_steps"]))
            return real(*a, **k)

        fr.fused_call = call
        try:
            yield kept
        finally:
            fr.fused_call = real

    return context()


def phase_big(torch, np):
    """Bodies past one block's shared memory: K1's and B4's device-memory
    instances (the robot's buffer in device memory, `k1_instance`).
    (a) Each against its shared-memory twin on bodies both run (the twin
    forced with `_device_instances`), every state
    and stats channel bit for bit: K1 on the evaluator batch with contact,
    the bench 10^3 design with and without contact, face and facet drag,
    the growth ramps, the features, the material instance (MDL_DATA,
    plasticity, the clamp), the compact contact pass, the volume instance,
    the evaluator batch with 4 knots, the SQP solve's K1 launch (8 x 10^3,
    segmented, 8 knots) from rest and at seg_base 75, and the cantilever
    with its BC channels; B4 on the SQP launch (8 x 10^3 x 25 steps) on
    land and in its three variants. (b) Against the plain versions at the
    new sizes: the big-body batch (`bench.big_body_workload`: 32 robots,
    30 % holes, a body and pair table per robot) at 12^3 and 13^3 with
    contact, 8 x 16^3 without, a 12^3 swimmer in its 13^3 shell with the
    facet drag and contact (K1's tolerances, `MESH_TOL` for the facet
    drag), the SQP solve's K1 launch from rest at 12^3, and B4 on
    8 x 12^3 x 25 steps against autograd (2e-3 a channel group), each launch
    counted as a device-memory one; after (d), the main paths' own launches
    (kept by `_keeping_launch`): the 12^3 cantilever's replay over its first
    200 steps, the cold CEM solve's first launch and the SQP solve's first
    segment past seg_base 0.
    (c) The guard: one buffer for every
    robot must fail. (d) Times with their bounds: K1 on 1024 x 12^3 x 200
    without contact, the device-memory instance forced on 1024 x 10^3 x 200
    against the shared one in turns; then the main paths at 12^3, every
    launch counter set to 0 just before each and read just after: two
    generations of the basic experiment at 12^3 with contact (pop 15, sim
    time cut to BIG_SIM_TIME), the 12^3 cantilever's replay, a cold CEM
    solve (`bench.mpc(n=12)`) and the fused SQP solve
    (`bench.sqp(n=12)`). Returns the records the kernels line reads."""
    import math
    import tempfile
    from unittest import mock

    from evosoro_tpu_torch import bench, roofline
    from evosoro_tpu_torch.buildcmp import sqp_b4_launch, sqp_k1_launch
    from evosoro_tpu_torch.ops import fused_rollout as fr

    out = {}
    # (a) device-memory against shared-memory instances, bit for bit
    pairs = [("evaluator batch 16 x 6^3, contact on, staggered",
              bench.evaluator_workload(collision=True, stagger=True, device="cuda"), 100),
             ("bench 8 x 10^3", bench.packed_workload(8, device="cuda")[:2], 100),
             ("bench 8 x 10^3, contact on",
              bench.packed_workload(8, collision=True, device="cuda")[:2], 25),
             ("bench 8 x 10^3 in 11^3, face drag",
              bench.packed_workload(8, device="cuda", fluid="face")[:2], 100),
             ("bench 8 x 10^3 in 11^3, facet drag",
              bench.packed_workload(8, device="cuda", fluid="mesh")[:2], 100),
             ("bench 8 x 10^3, growth ramps",
              bench.packed_workload(8, device="cuda", devo=True)[:2], 100),
             ("evaluator batch 16 x 6^3, features, windows of 4, 3 sources",
              bench.feature_workload(n_win=4, n_src=3, device="cuda"), 240),
             ("materials batch 16 x 6^3, MDL_DATA, plasticity, clamp, contact on",
              bench.materials_workload(device="cuda"), 100),
             ("bench 4 x 10^3, materials, compact contact pass",
              bench.packed_workload(4, device="cuda", materials=True, collision=True,
                                    compact=True)[:2], 25),
             ("volume batch 16 x 6^3, contact on", bench.volume_workload(device="cuda"), 100)]
    # control knots: the evaluator batch with 4 knots, and the fused SQP
    # solve's K1 launches in segmented mode (8 knots), from rest and at
    # seg_base 75 from where the first ends
    ev_args, ev_kw = bench.evaluator_workload(collision=True, device="cuda")
    B, _, V = ev_args[0].shape
    pairs.append(("evaluator batch 16 x 6^3, contact on, 4 knots", (ev_args, dict(
        ev_kw, control_packed=_controls(torch, np, B, 4, V, seed=4), n_knots=4)), 25))
    sq_args, sq_kw = sqp_k1_launch()
    st75, ss75 = fr.fused_call(*sq_args, num_steps=75, **sq_kw)
    pairs += [("SQP launch 8 x 10^3, segmented, 8 knots, from rest", (sq_args, sq_kw), 75),
              ("SQP launch 8 x 10^3, segmented, 8 knots, seg_base 75",
               ((st75, sq_args[1], ss75, None), dict(sq_kw, seg_base=75)), 25)]
    # the BC channels: the cantilever read with load_vxa
    with tempfile.TemporaryDirectory() as tmp:
        cl_args, cl_kw, _ = bench.cantilever_workload(os.path.join(tmp, "cantilever.vxa"),
                                                      batch=2, device="cuda")
    pairs.append(("cantilever 2 x 10^3, BC channels (load_vxa)", (cl_args, cl_kw), 200))
    recs = []
    for label, (args, kw), steps in pairs:
        g0 = fr.FUSED_ROLLOUT_GMEM_LAUNCHES
        a = fr.fused_call(*args, num_steps=steps, **kw)
        g1 = fr.FUSED_ROLLOUT_GMEM_LAUNCHES
        with _device_instances(fr):
            b = fr.fused_call(*args, num_steps=steps, **kw)
        torch.cuda.synchronize()
        rec = dict(phase="big_device_vs_shared", kernel="K1", workload=label, steps=steps,
                   shared_launches=1 - (g1 - g0),
                   device_launches=fr.FUSED_ROLLOUT_GMEM_LAUNCHES - g1,
                   state_bit_equal=torch.equal(a[0], b[0]),
                   stats_bit_equal=torch.equal(a[1], b[1]),
                   moved=float((a[0][:, :3] - args[0][:, :3]).abs().max()))
        rec["ok"] = rec["shared_launches"] == rec["device_launches"] == 1 \
            and rec["state_bit_equal"] and rec["stats_bit_equal"] and rec["moved"] > 0
        emit(rec)
        assert rec["ok"], rec
        recs.append(rec)
    for model, wkw in (("land", {}), ("facet drag", dict(fluid="mesh")),
                       ("voxel-face drag", dict(fluid="face")), ("growth", dict(devo=True))):
        st, bo, ss, ctrl, cot, kw = sqp_b4_launch(**wkw)
        g0 = fr.FUSED_BWD_GMEM_LAUNCHES
        a = fr.fused_bwd_call(st, bo, ss, ctrl, 75, cot, **kw)
        assert fr.FUSED_BWD_GMEM_LAUNCHES == g0
        with _device_instances(fr):
            b = fr.fused_bwd_call(st, bo, ss, ctrl, 75, cot, **kw)
        torch.cuda.synchronize()
        rec = dict(phase="big_device_vs_shared", kernel="B4",
                   workload="SQP launch 8 x %s, %s, 75 steps in" % (
                       "x".join(map(str, kw["grid_shape"])), model), steps=25,
                   device_launches=fr.FUSED_BWD_GMEM_LAUNCHES - g0,
                   bit_equal=all(torch.equal(x, y) for x, y in zip(a, b)),
                   nonzero=bool(a[1].abs().max() > 0))
        rec["ok"] = rec["device_launches"] == 1 and rec["bit_equal"] and rec["nonzero"]
        emit(rec)
        assert rec["ok"], rec
        recs.append(rec)
    out["bit_equal"] = recs

    # (b) against the plain versions at the new sizes
    k1 = []
    for n, coll, B in ((12, True, 32), (13, True, 32), (16, False, 8)):
        args, kw, n_occ = bench.big_body_workload(B, n=n, collision=coll, device="cuda")
        assert fr.k1_instance(n ** 3, coll) == "device"
        k0, g0 = fr.FUSED_ROLLOUT_LAUNCHES, fr.FUSED_ROLLOUT_GMEM_LAUNCHES
        k1 += _k1_cases(torch, fr, "big-body batch %d x %d^3, %d occupied, a body and pair "
                        "table per robot" % (B, n, n_occ), args, kw, B, coll, (1, 100),
                        time_at=100 if n < 16 else None, phase="big_vs_plain", n=n)
        assert fr.FUSED_ROLLOUT_GMEM_LAUNCHES - g0 == fr.FUSED_ROLLOUT_LAUNCHES - k0 > 0
        if n == 12:
            big12 = (args, kw)
    args, kw, _ = bench.big_body_workload(32, n=12, device="cuda", fluid=True)
    k1 += _k1_cases(torch, fr, "big-body swimmer 32 x 12^3 in its 13^3 shell, facet drag",
                    args, kw, 32, True, (100,), phase="big_vs_plain", tol=MESH_TOL, n=13,
                    drag="facet")
    sq_args, sq_kw = sqp_k1_launch(n=12)
    k1 += _k1_cases(torch, fr, "SQP launch 8 x 12^3, segmented, 8 knots, from rest", sq_args,
                    sq_kw, 8, False, (75,), phase="big_vs_plain", n=12)
    out["k1"] = k1
    st, bo, ss, ctrl, cot, kw = sqp_b4_launch(n=12)
    b0 = fr.FUSED_BWD_GMEM_LAUNCHES
    out["b4"] = _b4_case(torch, np, fr, "SQP launch 8 x 12^3, no floor, no gravity, 75 steps "
                         "in", st, bo, ss, ctrl, 75, kw, seed=9, timed=True)
    assert fr.FUSED_BWD_GMEM_LAUNCHES > b0

    # (c) the guard: every robot handed robot 0's buffer
    args, kw = big12
    out_p, st_p = _plain(fr, *args, num_steps=25, **kw)
    with mock.patch.object(fr, "_bond_buffer", lambda B, floats, device: torch.empty(
            (1, floats), device=device).expand(B, -1)):
        out_g, st_g = fr.fused_call(*args, num_steps=25, **kw)
    torch.cuda.synchronize()
    passes, errs = _compare(torch, fr, out_g, st_g, out_p, st_p)
    rec = dict(phase="big_guard", workload="big-body batch 32 x 12^3, 25 steps, one buffer "
               "for every robot", passes=passes, pos_err=errs["pos"], ok=not passes)
    emit(rec)
    assert rec["ok"], rec

    # (d) times
    args, kw, n_occ = bench.big_body_workload(1024, n=12, collision=False, device="cuda")
    ms = bench.time_call(lambda: fr.fused_call(*args, num_steps=200, **kw), 2, 2)
    _, st200 = fr.fused_call(*args, num_steps=200, **kw)
    rec = dict(phase="big_time", workload="big-body batch 1024 x 12^3 x 200 steps, contact off",
               ms=ms, voxel_steps_per_s=n_occ * 1024 * 200 / (ms * 1e-3),
               **roofline.bound(*roofline.launch_work(*args, st200, flags=kw["flags"],
                                                      grid_shape=kw["grid_shape"])))
    emit(rec)
    out["time_1024x12"] = rec
    del args
    args, kw, _ = bench.packed_workload(1024, device="cuda")
    times = dict(shared=[], device=[])
    for which in ("shared", "device", "device", "shared"):
        def run():
            return fr.fused_call(*args, num_steps=200, **kw)

        if which == "device":
            with _device_instances(fr):
                times[which].append(bench.time_call(run, 2, 3))
        else:
            times[which].append(bench.time_call(run, 2, 3))
    rec = dict(phase="big_time", workload="bench 1024 x 10^3 x 200 steps, the device-memory "
               "instance forced against the shared one, in turns",
               shared_ms=times["shared"], device_ms=times["device"],
               device_over_shared=min(times["device"]) / min(times["shared"]))
    emit(rec)
    out["time_1024x10"] = rec
    del args

    counters = dict(fused_rollout="FUSED_ROLLOUT_LAUNCHES",
                    fused_rollout_device="FUSED_ROLLOUT_GMEM_LAUNCHES",
                    fused_rollout_with_contact="FUSED_ROLLOUT_CONTACT_LAUNCHES",
                    fused_rollout_with_knots="FUSED_ROLLOUT_KNOT_LAUNCHES",
                    fused_rollout_material="FUSED_ROLLOUT_MATERIAL_LAUNCHES",
                    fused_bwd="FUSED_BWD_LAUNCHES", fused_bwd_device="FUSED_BWD_GMEM_LAUNCHES")

    def zero():
        for name in counters.values():
            setattr(fr, name, 0)

    def read():
        return {k: getattr(fr, name) for k, name in counters.items()}

    paths = {}
    zero()
    t0 = time.perf_counter()
    records = bench.evolution(gens=2, pop_size=15, device="cuda", experiment="basic",
                              size=(12, 12, 12), sim_time=BIG_SIM_TIME, init_time=BIG_INIT_TIME)
    paths["evolution"] = read()
    for r in records:
        fits = r.pop("fitnesses")
        r.update(phase="big_evolution", experiment="basic 12^3", sim_time=BIG_SIM_TIME,
                 sim_time_cut_from=5.0, n_evaluated_valid=len([f for f in fits if f > -1e6]),
                 all_finite=all(math.isfinite(f) for f in fits))
        emit(r)
        assert r["all_finite"] and r["n_evaluated_valid"] > 0 and r["k1_launches"] > 0, r
    launches = paths["evolution"]
    emit(dict(phase="big_evolution_launches", seconds=time.perf_counter() - t0, **launches))
    assert launches["fused_rollout_device"] == launches["fused_rollout"] \
        == launches["fused_rollout_with_contact"] > 0, launches

    def first(k):
        return True

    zero()
    with tempfile.TemporaryDirectory() as tmp, _keeping_launch(torch, fr, first) as kept_replay:
        rec = bench.replay(bench.write_cantilever_vxa(os.path.join(tmp, "cantilever.vxa"),
                                                      n=12))
    paths["replay"] = read()
    final = rec.pop("final_state")
    rec.update(phase="big_replay", finite=bool(torch.isfinite(final.pos).all()))
    emit(rec)
    assert rec["finite"] and not rec["diverged"] and rec["voxels"] == 12 ** 3, rec
    assert paths["replay"]["fused_rollout_device"] == paths["replay"]["fused_rollout"] \
        == paths["replay"]["fused_rollout_material"] == rec["launches"], paths

    zero()
    with _keeping_launch(torch, fr, first) as kept_mpc:
        mpc = bench.mpc(device="cuda", n=12)
    paths["mpc"] = read()
    for name, r in mpc.items():
        emit(dict(phase="big_mpc", record=name, **r))
    solve = mpc["solve"]
    assert all(math.isfinite(c) for c in solve["best_cost_trace"]), solve
    assert paths["mpc"]["fused_rollout_device"] == paths["mpc"]["fused_rollout"] > 0, paths

    zero()
    with _keeping_launch(torch, fr, lambda k: int(k.get("seg_base") or 0) > 0) as kept_sqp:
        rec = bench.sqp(device="cuda", n=12)
    paths["sqp"] = read()
    emit(dict(phase="big_sqp", **rec))
    _sqp_checks(rec, paths["sqp"])
    assert paths["sqp"]["fused_rollout_device"] == 4 * 72, paths
    assert paths["sqp"]["fused_bwd_device"] == 4 * 32, paths
    emit(dict(phase="big_launches", **paths))
    out["paths"] = paths

    # the main paths' own launches against the plain version, after the
    # counts were read: the replay's (BC channels and the clamp), the cold
    # CEM solve's first (8 knots over 200 steps) and the SQP solve's first
    # segment past seg_base 0
    # (the replay's launch over its first 200 steps, the CEM solve's over
    # its first 100: the plain version's whole 781 took 34 s of the full run)
    for label, kept, tol in (
            ("12^3 cantilever's replay launch (BC channels, the clamp)", kept_replay,
             _strictest("bc", "max_vel")),
            ("cold CEM solve's first launch", kept_mpc, TOL),
            ("fused SQP solve's first segment past seg_base 0", kept_sqp, TOL)):
        (args, kw, steps), = kept
        steps = min(steps, 200 if kept is kept_replay else 100)
        B = args[0].shape[0]
        g0 = fr.FUSED_ROLLOUT_GMEM_LAUNCHES
        out["k1"] += _k1_cases(torch, fr, "%s, %d x %s, %d steps%s%s" % (
            label, B, "x".join(map(str, kw["grid_shape"])), steps,
            ", %d knots" % kw["n_knots"] if kw.get("n_knots") else "",
            "" if kw.get("seg_base") is None else ", seg_base %d" % int(kw["seg_base"])),
            args, kw, B, bool(kw["flags"].get("collision")), (steps,), phase="big_vs_plain",
            tol=tol, n=12)
        assert fr.FUSED_ROLLOUT_GMEM_LAUNCHES == g0 + 1
    return out


def _big_rows(big, bound_keys):
    """The kernels line's rows of K1's and B4's device-memory instances."""
    timed = next(r for r in big["k1"] if "ms" in r and r["n"] == 12)
    t13 = next(r for r in big["k1"] if "ms" in r and r["n"] == 13)
    paths = big["paths"]
    b4 = big["b4"]
    return [
        dict(name="fused_rollout (K1), device-memory instances", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout_gmem.cu",
             replaces="evosoro_tpu/ops/fused_rollout.py:777",
             launches=sum(p["fused_rollout_device"] for p in paths.values()),
             launches_of="at 12^3: two generations of the basic experiment with contact "
             "(%d), the cantilever's replay (%d), a cold CEM solve and its closed loop "
             "(%d), a fused SQP solve and 3 re-plans (%d)" % tuple(
                 paths[k]["fused_rollout_device"] for k in ("evolution", "replay", "mpc",
                                                            "sqp")),
             **bound_keys(timed),
             max_abs_err=max(r["pos"] for r in big["k1"]),
             not_state_bit_equal_to_plain=[r["workload"] for r in big["k1"]
                                           if not r["state_bit_equal"]],
             bit_equal_to_shared=all(r["state_bit_equal"] and r["stats_bit_equal"]
                                     for r in big["bit_equal"] if r["kernel"] == "K1"),
             err_of=("pos (m) against the plain version: the big-body batch 32 x 12^3 and "
                     "32 x 13^3 with contact, 8 x 16^3 without, 1 and 100 steps; the "
                     "12^3 swimmer in its 13^3 shell with the facet drag and contact, 100 "
                     "steps (MESH_TOL); the SQP launch 8 x 12^3 from rest, 75 steps; the "
                     "main paths' own launches: the 12^3 cantilever's replay (its first "
                     "200 steps), the "
                     "cold CEM solve's first launch (128 x 12^3, 8 knots, its first 100 "
                     "steps), the "
                     "SQP solve's first 25-step segment past seg_base 0. Bit-equal to "
                     "the shared instance (bit_equal_to_shared): 10 K1 workloads, the "
                     "evaluator batch with 4 knots, the 10^3 SQP launch from rest and at "
                     "seg_base 75 and the 10^3 cantilever with its BC channels"),
             ms=timed["ms"], plain_ms=timed["plain_ms"],
             ms_of="big-body batch 32 x 12^3 x 100 steps, contact on",
             ms_32x13_3x100=t13["ms"], bound_ms_32x13_3x100=t13["bound_ms"],
             ms_1024x12_3x200=big["time_1024x12"]["ms"],
             bound_ms_1024x12_3x200=big["time_1024x12"]["bound_ms"],
             ms_1024x10_3x200_device=min(big["time_1024x10"]["device_ms"]),
             ms_1024x10_3x200_shared=min(big["time_1024x10"]["shared_ms"])),
        dict(name="fused_rollout_bwd (B4), device-memory instance", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout_bwd.cu",
             replaces="evosoro_tpu/ops/fused_rollout.py:2745",
             launches=paths["sqp"]["fused_bwd_device"],
             launches_of="bench.sqp(n=12): a cold solve and 3 re-plans",
             **bound_keys(b4), max_abs_err=b4["max_abs_err"],
             worst_rel_err=b4["worst_rel_err"],
             bit_equal_to_shared=all(r["bit_equal"] for r in big["bit_equal"]
                                     if r["kernel"] == "B4"),
             err_of=("cotangent of the controls against autograd through the plain "
                     "version, SQP launch 8 x 12^3 x 25 steps, 8 knots, 75 steps in; "
                     "worst_rel_err as the land row"),
             ms=b4["ms"], plain_ms=b4["plain_ms"],
             ms_of="one launch of a solve: 8 x 12^3, 25 steps at seg_base 75, 8 knots")]


# the off-path tools' phase (`--tools`): examples/visualize.py's default
# robot, tests/test_fea.py's beams, tests/test_sandbox.py's sandbox and poke
TOOLS_POKE = ((1, 1, 1), (200.0, 0.0, 0.0), 40)
# the full run's cut of the K1 parity scenarios (onchip_parity.STEPS alone)
TOOLS_CUT = dict(parity_steps=25)
# the renderer's vertices on the card against the CPU: float32 sums of the
# 8 corner poses in another order, a few ulps of a coordinate
RENDER_RTOL = 1e-6


def _visualize_robot(torch, np, device):
    """examples/visualize.py's default robot: a random 6^3 design (seed 0)
    with the renderer's surface mesh, 0.6 s of sim time, ~60 frames."""
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body, calc_max_dt
    from evosoro_tpu_torch.core import palette_from_list
    from evosoro_tpu_torch.core.types import evosoro_default_palette
    from evosoro_tpu_torch.envs.drag import attach_mesh_drag

    rng = np.random.default_rng(0)
    structure = rng.integers(0, 5, size=(6, 6, 6)).astype(np.int32)
    structure[3, 3, 0] = 3
    phase = rng.uniform(-1, 1, size=(6, 6, 6))
    body = attach_mesh_drag(build_body(structure, palette_from_list(evosoro_default_palette()),
                                       phase_offset=phase, device=device))
    sim = SimParams(stop_condition_value=0.6, init_cm_time=0.1)
    dt = calc_max_dt(body) * sim.dt_frac
    num_steps = int(float(sim.stop_condition_value) / float(dt))
    return body, sim, EnvParams(), dt, num_steps, max(1, num_steps // 60)


def _tools_beam(torch, n, clamped, device):
    """tests/test_fea.py's beam in float64: n voxels along x, E 1e6, 1 mm."""
    import numpy as np

    from evosoro_tpu_torch.core import Material, build_body, palette_from_list

    structure = np.zeros((n, 1, 1), dtype=np.int32)
    structure[:, 0, 0] = 1
    fixed = np.zeros((n, 1, 1), dtype=np.int32)
    if clamped:
        fixed[0, 0, 0] = 63
    return build_body(structure, palette_from_list([Material(1, elastic_mod=1e6, density=1e3)]),
                      lattice_dim=0.001, dof_fixed=fixed, dtype=torch.float64, device=device)


def _tools_sandbox(torch, np, device):
    """tests/test_sandbox.py's sandbox: a 3x3x2 design, muscle under tissue."""
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body, palette_from_list
    from evosoro_tpu_torch.core.types import evosoro_default_palette
    from evosoro_tpu_torch.viz.sandbox import InteractiveSandbox

    rng = np.random.default_rng(3)
    s = np.zeros((3, 3, 2), dtype=np.int32)
    s[:, :, 0] = 3
    s[:, :, 1] = 1
    body = build_body(s, palette_from_list(evosoro_default_palette()),
                      phase_offset=rng.uniform(-1, 1, size=s.shape), device=device)
    return InteractiveSandbox(body, SimParams(init_cm_time=0.0), EnvParams())


def phase_tools(torch, np, card, parity_steps=None, alone=False):
    """The off-path tools on the card. (a) `record_trajectory` of
    examples/visualize.py's default robot through K1 (one launch a frame,
    the state and stats row carried over), its frames bit-equal to one K1
    launch at three frame boundaries, its first 100 steps against the eager
    route, a frame's launch against K1's plain version (the kernels line's
    figures in `--tools`); (b) the renderer's vertices, triangles, owners
    and face colours on the card against the CPU, the deformed mesh written
    through `io.mesh_io` (the card's host has no matplotlib: no raster);
    (c) `fea_solve` and `tensile_test` in float64 on tests/test_fea.py's
    beams at its analytic tolerances; (d) the sandbox's scripted REPL and
    the CoM shift of tests/test_sandbox.py's poke; (e) the 12 K1 parity
    scenarios of `onchip_parity` (`parity_steps`; its line holds the whole
    record, and alone the run is held to the committed
    ONCHIP_PARITY_TORCH.json by the JAX tool's rule). The counts are zeroed
    before (a)'s recording and (e) and read after them; returns K1's
    launches there."""
    import io
    import tempfile

    from evosoro_tpu_torch import onchip_parity
    from evosoro_tpu_torch.analysis import fea_solve, tensile_test
    from evosoro_tpu_torch.core import init_state
    from evosoro_tpu_torch.io import mesh_io
    from evosoro_tpu_torch.ops import fused_rollout as fr
    from evosoro_tpu_torch.viz import render, trajectory
    from evosoro_tpu_torch.viz.sandbox import repl

    parity_steps = parity_steps or onchip_parity.STEPS

    # (a) the trajectory, through K1
    body, sim, env, dt, num_steps, every = _visualize_robot(torch, np, "cuda")
    n_frames = max(1, num_steps // every)
    fr.FUSED_ROLLOUT_LAUNCHES = 0
    t0 = time.perf_counter()
    traj = trajectory.record_trajectory(body, sim, env, num_steps, dt=dt, every=every)
    torch.cuda.synchronize()
    traj_s = time.perf_counter() - t0
    traj_k1 = fr.FUSED_ROLLOUT_LAUNCHES
    reason = trajectory.eager_reason(body, sim, env, init_state(body))
    boundaries = sorted({1, n_frames // 2, n_frames - 1})
    bit_equal = {}
    for f in boundaries:
        one = trajectory.K1Chain(body, sim, env, init_state(body), dt, num_steps).advance(
            f * every)
        bit_equal[f] = all(torch.equal(a, b[f]) for a, b in zip(
            one.pose(), (traj.pos, traj.quat, traj.scale, traj.time)))
    k1_100 = trajectory._record(body, sim, env, 100, dt, 10, init_state(body), None, "k1")
    t1 = time.perf_counter()
    eager_100 = trajectory._record(body, sim, env, 100, dt, 10, init_state(body), None,
                                   "eager")
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t1
    dpos = max(float((k1_100.pos - eager_100.pos).abs().max()),
               float((k1_100.final_state.pos - eager_100.final_state.pos).abs().max()))
    rec = dict(phase="tools_trajectory", card=card,
               workload="examples/visualize.py's robot, 6^3 seed 0, 0.6 s: %d steps, every %d"
               % (num_steps, every), frames=int(traj.pos.shape[0]), seconds=traj_s,
               k1_launches=traj_k1, eager_reason=reason,
               frames_finite=bool(torch.isfinite(traj.pos).all()),
               bit_equal_to_one_launch_at_frames=bit_equal,
               first_100_steps_max_abs_dpos_k1_vs_eager_m=dpos,
               eager_100_steps_s=eager_s, drift_bound_m=DRIFT_BOUND_M)
    emit(rec)
    assert reason is None and traj_k1 == n_frames + int(num_steps > n_frames * every), rec
    assert rec["frames_finite"] and all(bit_equal.values()), rec
    assert dpos <= DRIFT_BOUND_M, rec
    chain = trajectory.K1Chain(body, sim, env, init_state(body), dt, num_steps)
    k1_rec = _k1_cases(torch, fr, "visualize.py robot 6^3, one frame's launch",
                       (chain.state, chain.body_packed, chain.stats, chain.collision),
                       chain.kw, 1, False, (every,), time_at=every,
                       phase="tools_k1_vs_plain")[0]

    # (b) the renderer's surface, card against CPU, and the mesh file
    f = n_frames // 2
    pose = (traj.pos[f], traj.quat[f], traj.scale[f])
    cpu_body = body.to("cpu").replace(mesh_drag=body.mesh_drag.to("cpu"))
    got = render.surface(body, pose)
    want = render.surface(cpu_body, tuple(t.cpu() for t in pose))
    with tempfile.TemporaryDirectory() as tmp:
        stl = os.path.join(tmp, "final_state.stl")
        verts, tris = mesh_io.export_deformed_mesh(stl, traj.final_state, body)
        back_verts, back_tris = mesh_io.read_stl(stl)
        stl_bytes = os.path.getsize(stl)
    rec = dict(phase="tools_render", card=card, frame=f, triangles=int(got[1].shape[0]),
               vertices_max_abs_err_m=float(np.abs(got[0] - want[0]).max()),
               vertices_within_rtol=bool(np.allclose(got[0], want[0], rtol=RENDER_RTOL,
                                                     atol=0.0)),
               render_rtol=RENDER_RTOL,
               tables_and_colours_equal=all(np.array_equal(a, b)
                                            for a, b in zip(got[1:], want[1:])),
               stl_bytes=stl_bytes, stl_triangles=int(len(tris)),
               stl_read_back_triangles=int(len(back_tris)))
    emit(rec)
    assert rec["vertices_within_rtol"] and rec["tables_and_colours_equal"], rec
    assert len(tris) > 0 and len(back_tris) == len(tris), rec

    # (c) static FEA and the tensile test in float64 on the card
    n, P = 10, 1e-4
    ext = torch.zeros((n, 1, 1, 3), dtype=torch.float64)
    ext[-1, 0, 0, 2] = -P
    t0 = time.perf_counter()
    sol = fea_solve(_tools_beam(torch, n, True, "cuda"), ext_force=ext, tol=1e-12)
    cant_s = time.perf_counter() - t0
    analytic = -P * (9e-3) ** 3 / (3.0 * 1e6 * 1e-12 / 12.0)
    tip_err = abs(float(sol["displacement"][-1, 0, 0, 2]) - analytic) / abs(analytic)
    ext = torch.zeros((6, 1, 1, 3), dtype=torch.float64)
    ext[-1, 0, 0, 0] = 1e-3
    t0 = time.perf_counter()
    ax = fea_solve(_tools_beam(torch, 6, True, "cuda"), ext_force=ext, tol=1e-12)
    axial_s = time.perf_counter() - t0
    k = 1e6 * 1e-3 / 5
    axial_err = abs(float(ax["displacement"][-1, 0, 0, 0]) - 1e-3 / k) / (1e-3 / k)
    t0 = time.perf_counter()
    ten = tensile_test(_tools_beam(torch, 6, False, "cuda"), axis=0,
                       strains=np.array([0.005, 0.01]))
    ten_s = time.perf_counter() - t0
    mod = (ten["stress"] / ten["strain"]).cpu().numpy()
    rec = dict(phase="tools_fea", card=card, dtype="float64",
               cantilever=dict(voxels=n, cg_iterations=sol["iterations"], seconds=cant_s,
                               tip_rel_err=tip_err, residual=float(sol["residual"])),
               axial=dict(voxels=6, cg_iterations=ax["iterations"], seconds=axial_s,
                          tip_rel_err=axial_err),
               tensile=dict(voxels=6, cg_iterations=ten["iterations"], seconds=ten_s,
                            modulus_rel_err=float(np.abs(mod / 1e6 - 1.0).max())))
    emit(rec)
    assert sol["displacement"].device.type == "cuda", rec
    assert tip_err < 1e-6 and rec["cantilever"]["residual"] < 1e-10, rec
    assert axial_err < 1e-8 and rec["tensile"]["modulus_rel_err"] < 1e-6, rec

    # (d) the sandbox's scripted REPL, and the poke's CoM shift
    sb = _tools_sandbox(torch, np, "cuda")
    (x, y, z), (fx, fy, fz), dur = TOOLS_POKE
    text = io.StringIO()
    repl(sb, stdin=io.StringIO(f"i\ns 5\np {x} {y} {z} {fx} {fy} {fz} {dur}\ns 10\nc\ni\nz\nq\n"),
         stdout=text)
    text = text.getvalue()
    plain = _tools_sandbox(torch, np, "cuda").step(5)
    poked = _tools_sandbox(torch, np, "cuda").step(5)
    poked.apply_force(*TOOLS_POKE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.step(60)
    torch.cuda.synchronize()
    ms_per_step = 1e3 * (time.perf_counter() - t0) / 60
    poked.step(60)
    shift = float(poked.center_of_mass()[0] - plain.center_of_mass()[0])
    rec = dict(phase="tools_sandbox", card=card, repl_lines=text.count("\n"),
               repl_ok=all(s in text for s in ("t=", "poking", "pokes cleared", "reset."))
               and "error" not in text, steps_after_reset=sb.steps_done,
               poke_com_shift_x_m=shift, eager_ms_per_step=ms_per_step,
               device=str(plain.state.pos.device))
    emit(rec)
    assert rec["repl_ok"] and sb.steps_done == 0 and shift > 1e-7, (rec, text)

    # (e) K1 against the eager step, the 12 scenarios
    fr.FUSED_ROLLOUT_LAUNCHES = 0
    t0 = time.perf_counter()
    par = onchip_parity.measure(steps=parity_steps, device="cuda")
    par_k1 = fr.FUSED_ROLLOUT_LAUNCHES
    bad = {k: v for k, v in par["scenarios"].items()
           if not (np.isfinite(v["max_abs_pos_diff_m"]) and not v["diverged"]
                   and v["max_abs_pos_diff_m"] < 0.01 * v["pos_span_m"])}
    rec = dict(phase="tools_onchip_parity", card=card, steps=parity_steps,
               seconds=time.perf_counter() - t0, k1_launches=par_k1, outside=bad,
               max_abs_pos_diff_m=max(v["max_abs_pos_diff_m"]
                                      for v in par["scenarios"].values()),
               bit_equal=[k for k, v in par["scenarios"].items()
                          if v["max_abs_pos_diff_m"] == 0.0], record=par)
    if alone:
        committed = os.path.join(HERE, "ONCHIP_PARITY_TORCH.json")
        if os.path.exists(committed):
            with open(committed) as fh:
                rec["check_against_committed"] = onchip_parity.check(par, json.load(fh))
    emit(rec)
    assert not bad and par_k1 == len(onchip_parity.SCENARIOS), rec
    assert not rec.get("check_against_committed"), rec
    return dict(fused_rollout=traj_k1 + par_k1, trajectory=traj_k1, parity=par_k1,
                k1=k1_rec)


def _tools_row(tools, bound_keys):
    """The kernels line's K1 row of `--tools`."""
    k1 = tools["k1"]
    return dict(
        name="fused_rollout (K1)", route="cuda",
        source="evosoro_tpu_torch/ops/csrc/fused_rollout.cu",
        replaces="evosoro_tpu/ops/fused_rollout.py:777",
        launches=tools["fused_rollout"],
        launches_of="record_trajectory of examples/visualize.py's robot (%d) and the 12 "
        "K1 parity scenarios (%d)" % (tools["trajectory"], tools["parity"]),
        **bound_keys(k1), max_abs_err=k1["pos"],
        err_of="pos (m) against the plain version: one frame's launch (%d steps) of the "
        "visualize.py robot, 6^3" % k1["steps"],
        ms=k1["ms"], plain_ms=k1["plain_ms"],
        ms_of="one frame's launch, 1 x 6^3, %d steps" % k1["steps"])


def main():
    if not os.path.isdir(os.path.join(HERE, "evosoro_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository "
                         "(evosoro_tpu_torch/ not found beside it)")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    card = phase_device(torch)
    phase_build()
    if sys.argv[1:] == ["--land"]:
        return phase_land(torch, np, card)
    if sys.argv[1:3] == ["--diff", "--against"] and len(sys.argv) == 4:
        phase_b4_against(torch, np, sys.argv[3])
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return None
    if sys.argv[1:] == ["--diff"]:
        b4 = phase_b4(torch, np)
        b4_var, k1_sqp = phase_b4_variants(torch, np)
        b4_mat = phase_b4_materials(torch, np)
        sqp_launches = phase_sqp(torch, next(r for r in b4 if "ms" in r))
        var_launches = phase_sqp_variants(torch, b4_var)
        mat_launches = phase_sqp_materials(torch, b4_mat)

        def bound_keys(rec):
            return dict(bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None)

        emit(dict(kernels=_b4_rows(b4, b4_var, sqp_launches, var_launches, bound_keys)
                  + [_b4_material_row(b4_mat, mat_launches, bound_keys)]))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return None
    if sys.argv[1:2] == ["--step"] and sys.argv[2:3] in ([], ["--against"]):
        step = phase_step(torch, np, alone=True, against=(sys.argv[3:] or [None])[0])

        def bound_keys(rec):
            return dict(bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None)

        n = step["launches"]
        emit(dict(kernels=_step_rows(
            step, bound_keys, n["evolution"]["fused_rollout"] + n["cem_solve"]["fused_rollout"],
            n["cem_solve"]["fused_rollout_with_knots"])))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return None
    if sys.argv[1:2] == ["--compact"] and (len(sys.argv) == 2 or sys.argv[2:3] == ["--against"]
                                           and len(sys.argv) > 3):
        comp = phase_compact(torch, np)
        times = phase_compact_times(torch, np, against=sys.argv[3:])

        def bound_keys(rec):
            return dict(bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None)

        emit(dict(kernels=[_b5_row(
            comp["b5"], comp["fixtures"] + [comp["big"]], comp["launches"]["compact"],
            bound_keys, compact_over_dense=times["summary"]["compact_over_dense"],
            guard_ratio=comp["guard"]["guard_ratio"])]))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return None
    if sys.argv[1:] == ["--pair"]:
        k2 = phase_k2(torch, np)
        pair = phase_pair(torch, np, alone=True)

        def bound_keys(rec):
            return dict(bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None)

        emit(dict(kernels=[_k2_row(k2, pair, bound_keys, pair["k2_launches"],
                                   pair["contact_launches"])]))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return None
    if sys.argv[1:] == ["--big"]:
        big = phase_big(torch, np)

        def bound_keys(rec):
            return dict(bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None)

        emit(dict(kernels=_big_rows(big, bound_keys)))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return None
    if sys.argv[1:] == ["--mat-variants"]:
        k1_mv = phase_k1_mat_variants(torch, np)
        times = phase_mat_variants_times(torch, np)
        b4_mv, k1_sqp_mv = phase_b4_mat_variants(torch, np)
        sqp_mv = phase_sqp_mat_variants(torch, b4_mv)
        evo_mv = phase_evolution(torch, ("swimming_materials",))["swimming_materials"]

        def bound_keys(rec):
            return dict(bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None)

        emit(dict(kernels=_mat_variant_rows(k1_mv, k1_sqp_mv, b4_mv, sqp_mv, evo_mv, times,
                                                    bound_keys)))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return None
    if sys.argv[1:] == ["--parallel"]:
        par = phase_parallel(torch, np, card)
        k1 = par["k1"]
        emit(dict(kernels=[dict(
            name="fused_rollout (K1)", route="cuda",
            source="evosoro_tpu_torch/ops/csrc/fused_rollout.cu",
            replaces="evosoro_tpu/ops/fused_rollout.py:777",
            launches=par["fused_rollout"], launches_of="the parallel phase's sharded runs",
            bound_ms=k1["bound_ms"], bound_by=k1["bound_by"], library_ms=None,
            max_abs_err=k1["pos"], err_of="pos (m), bench 4^3 x 64, 25 steps, contact on",
            ms=k1["ms"], plain_ms=k1["plain_ms"], ms_of="bench 4^3 x 64, 25 steps, contact on")]))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return None
    if sys.argv[1:] == ["--tools"]:
        tools = phase_tools(torch, np, card, alone=True)

        def bound_keys(rec):
            return dict(bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None)

        emit(dict(kernels=[_tools_row(tools, bound_keys)]))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return None
    if sys.argv[1:] == ["--eager"]:
        phase_eager(torch, np, card)
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return None
    if sys.argv[1:] in (["--features"], ["--materials"], ["--volume"]):
        if sys.argv[1:] == ["--features"]:
            phase_k1_features(torch)
            phase_evolution(torch, ("features", "ballistic"))
        elif sys.argv[1:] == ["--volume"]:
            phase_k1_volume(torch, np)
        else:
            phase_k1_materials(torch, np, phase_replay(torch)[1])
            phase_evolution(torch, ("materials",))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return None
    k2 = phase_k2(torch, np)
    pair = phase_pair(torch, np)
    k1 = phase_k1(torch)
    step = phase_step(torch, np)
    knots = phase_k1_knots(torch, np, (1, 25))
    phase_k1_segmented(torch, np)
    fluid = phase_k1_fluid(torch)
    devo = phase_k1_devo(torch)
    feat_recs, feat_timed = phase_k1_features(torch)
    replay, replays = phase_replay(torch)
    mats = phase_k1_materials(torch, np, replays)
    vol = phase_k1_volume(torch, np, replays)
    k1_mv = phase_k1_mat_variants(torch, np)
    fma = phase_fp32_peak(torch)
    evo_launches = phase_evolution(torch)
    launches = evo_launches["basic"]
    swim, grow = evo_launches["swimming"], evo_launches["growth"]
    featx, balx = evo_launches["features"], evo_launches["ballistic"]
    matx = evo_launches["materials"]
    swimx = evo_launches["swimming_materials"]
    eager = phase_eager(torch, np, card, **EAGER_CUT)
    par = phase_parallel(torch, np, card, **PARALLEL_CUT)
    tools = phase_tools(torch, np, card, **TOOLS_CUT)
    mpc_launches, knot_timed, loop_recs = phase_mpc(torch, np)
    b4 = phase_b4(torch, np)
    b4_timed = next(r for r in b4 if "ms" in r)
    b4_var, k1_sqp = phase_b4_variants(torch, np)
    b4_mat = phase_b4_materials(torch, np)
    sqp_launches = phase_sqp(torch, b4_timed)
    var_launches = phase_sqp_variants(torch, b4_var)
    mat_launches = phase_sqp_materials(torch, b4_mat)
    b4_mv, k1_sqp_mv = phase_b4_mat_variants(torch, np)
    sqp_mv = phase_sqp_mat_variants(torch, b4_mv)
    big = phase_big(torch, np)
    big_k1 = sum(p["fused_rollout"] for p in big["paths"].values())
    phase_throughput(torch, card)
    k1_timed = next(r for r in k1 if "ms" in r)
    vol_cases = vol["a"] + [vol["a_guards"], vol["a_knots"]] + vol["b"] + [
        vol[k] for k in ("c", "d", "e", "e_knots", "f")]
    fluid_timed = next(r for r in fluid["mesh"] if "ms" in r)
    devo_timed = next(r for r in devo if "ms" in r)
    knots += [knot_timed, *loop_recs]
    sqp_k1 = [r for recs in k1_sqp.values() for r in recs]

    def at_measured_peak(rec):
        """A record's bound with the FP32 rate fma_peak measured in this run."""
        from evosoro_tpu_torch import roofline

        return roofline.bound(rec["flops"], rec["bytes"],
                              fp32_flops=fma["peak_flops_per_s"])["bound_ms"]

    def bound_keys(rec):
        return dict(bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                    bound_ms_at_measured_peak=at_measured_peak(rec),
                    library_ms=None)

    emit(dict(kernels=[
        dict(name="fused_rollout (K1)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout.cu",
             replaces="evosoro_tpu/ops/fused_rollout.py:777",
             launches=launches["fused_rollout"] + swim["fused_rollout"]
             + grow["fused_rollout"] + featx["fused_rollout"] + balx["fused_rollout"]
             + matx["fused_rollout"] + replay["fused_rollout"]
             + mpc_launches["fused_rollout"] + sqp_launches["fused_rollout"]
             + sum(v["fused_rollout"] for v in var_launches.values())
             + mat_launches["fused_rollout"]
             + vol["replay_launches"]["fused_rollout"] + vol["evolution"]["fused_rollout"]
             + vol["mpc_launches"]["fused_rollout"] + big_k1 + swimx["fused_rollout"]
             + sum(v["fused_rollout"] for v in sqp_mv.values()) + eager["fused_rollout"]
             + par["fused_rollout"] + tools["fused_rollout"],
             launches_evolution=launches["fused_rollout"],
             launches_swimming=swim["fused_rollout"],
             launches_growth=grow["fused_rollout"],
             launches_features=featx["fused_rollout"],
             launches_ballistic=balx["fused_rollout"],
             launches_materials=matx["fused_rollout"],
             launches_replay=replay["fused_rollout"],
             launches_mpc=mpc_launches["fused_rollout"],
             launches_sqp=sqp_launches["fused_rollout"],
             launches_sqp_water_growth=sum(v["fused_rollout"] for v in var_launches.values()),
             launches_sqp_materials=mat_launches["fused_rollout"],
             launches_volume=vol["replay_launches"]["fused_rollout"]
             + vol["evolution"]["fused_rollout"] + vol["mpc_launches"]["fused_rollout"],
             launches_big_bodies=big_k1,
             launches_swimming_materials=swimx["fused_rollout"],
             launches_sqp_materials_water_growth=sum(v["fused_rollout"]
                                                     for v in sqp_mv.values()),
             launches_eager_phase=eager["fused_rollout"],
             launches_parallel_phase=par["fused_rollout"],
             launches_tools=tools["fused_rollout"],
             **bound_keys(k1_timed),
             max_abs_err=max(r["pos"] for r in k1),
             err_of=("pos (m), evaluator batch %d x 6^3, 1/25/100 steps, "
                     "contact off and on, as packed and with dt/stop/IniCM per robot"
                     % k1_timed["batch"]),
             ms=k1_timed["ms"], plain_ms=k1_timed["plain_ms"],
             ms_of="evaluator batch %d x 6^3, 25 steps, contact on"
             % k1_timed["batch"], **_step_extras(step)[0]),
        _k2_row(k2, pair, bound_keys, launches["pair_contact"] + mpc_launches["pair_contact"],
                launches["fused_rollout_with_contact"] + swim["fused_rollout_with_contact"]
                + grow["fused_rollout_with_contact"] + eager["fused_rollout_with_contact"]
                + par["fused_rollout_with_contact"]),
        dict(name="K1 control knots + segments (B3)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout.cu",
             replaces="evosoro_tpu/ops/fused_rollout.py:1710",
             launches=mpc_launches["fused_rollout_with_knots"]
             + sqp_launches["fused_rollout_with_knots"]
             + sum(v["fused_rollout_with_knots"] for v in var_launches.values())
             + mat_launches["fused_rollout_with_knots"],
             launches_evolution=launches["fused_rollout_with_knots"],
             launches_sqp=sqp_launches["fused_rollout_with_knots"],
             launches_sqp_water_growth=sum(v["fused_rollout_with_knots"]
                                           for v in var_launches.values()),
             **bound_keys(knot_timed),
             max_abs_err=max(r["pos"] for r in knots + sqp_k1),
             err_of=("pos (m), bench 8 x 10^3 and evaluator batch 16 x 6^3, "
                     "K 1 and 4, 1/25 steps, contact off and on; the "
                     "solve's launch, 128 x 10^3, 8 knots, 200 steps; the "
                     "closed loop's plan (32 x 200 steps, 8 knots) and execute "
                     "(1 x 100 steps, 4 knots) launches after a segment; and the "
                     "fused SQP solve's segmented launches in water (facet and "
                     "voxel-face drag, 8 x 11^3) and with growth (8 x 5x5x4), 8 knots, "
                     "75 steps from rest and 25 steps at seg_base 75"),
             ms=knot_timed["ms"], plain_ms=knot_timed["plain_ms"],
             ms_of="one launch of a cold solve: 128 x 10^3, 8 knots, 200 steps",
             **_step_extras(step)[1]),
        *_b4_rows(b4, b4_var, sqp_launches, var_launches, bound_keys),
        _b4_material_row(b4_mat, mat_launches, bound_keys),
        *_big_rows(big, bound_keys),
        *_mat_variant_rows(k1_mv, k1_sqp_mv, b4_mv, sqp_mv, swimx, None, bound_keys),
        dict(name="K1 fluid branches (B7)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout_common.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:1373",
             launches=swim["fused_rollout_fluid"] + var_launches["mesh"]["fused_rollout_fluid"]
             + var_launches["face"]["fused_rollout_fluid"] + swimx["fused_rollout_fluid"]
             + sqp_mv["mesh"]["fused_rollout_fluid"] + sqp_mv["face"]["fused_rollout_fluid"],
             launches_of="two generations of the swimming experiment, every "
             "launch with the facet drag (%d); bench.sqp in water, facet and "
             "voxel-face drag (%d, %d); two generations of the swimming-materials "
             "experiment (%d); bench.sqp(materials=True) in water, facet and voxel-face "
             "drag (%d, %d)" % (swim["fused_rollout_mesh"],
                                var_launches["mesh"]["fused_rollout_fluid"],
                                var_launches["face"]["fused_rollout_fluid"],
                                swimx["fused_rollout_fluid"],
                                sqp_mv["mesh"]["fused_rollout_fluid"],
                                sqp_mv["face"]["fused_rollout_fluid"]),
             **bound_keys(fluid_timed),
             max_abs_err=max(r["pos"] for r in fluid["mesh"] + fluid["face"]
                             + k1_sqp["mesh"] + k1_sqp["face"]),
             max_abs_err_mesh=max(r["pos"] for r in fluid["mesh"] + k1_sqp["mesh"]),
             max_abs_err_face=max(r["pos"] for r in fluid["face"] + k1_sqp["face"]),
             face_state_bit_equal=all(r["state_bit_equal"]
                                      for r in fluid["face"] + k1_sqp["face"]),
             err_of=("pos (m) against the plain version, both drag models: bench "
                     "8 x 11^3 and the swimming evaluator batch (16 x 6^3 face, "
                     "16 x 7^3 mesh, a body per robot), 1/25/100 steps, contact "
                     "off and on; the fused SQP solve's segmented launches, 8 x 11^3, "
                     "8 knots, 75 steps from rest and 25 steps at seg_base 75"),
             ms=fluid_timed["ms"], plain_ms=fluid_timed["plain_ms"],
             ms_of="swimming evaluator batch %d x 7^3, facet drag, 25 steps, "
             "contact on" % fluid_timed["batch"]),
        dict(name="K1 growth ramps (B8a)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout_common.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:1628",
             launches=grow["fused_rollout_devo"] + var_launches["devo"]["fused_rollout_devo"]
             + sqp_mv["devo"]["fused_rollout_devo"],
             launches_of="two generations of the growth experiment, bench.sqp "
             "with growth (%d) and bench.sqp(materials=True) with growth (%d)" % (
                 var_launches["devo"]["fused_rollout_devo"],
                 sqp_mv["devo"]["fused_rollout_devo"]),
             **bound_keys(devo_timed),
             max_abs_err=max(r["pos"] for r in devo + k1_sqp["devo"]),
             max_abs_scale_err=max(r["scale"] for r in devo + k1_sqp["devo"]),
             state_bit_equal=all(r["state_bit_equal"] for r in devo + k1_sqp["devo"]),
             err_of=("pos (m) against the plain version: bench 8 x 10^3 with "
                     "random growth fields, without and with the mid-life freeze, "
                     "and the growth evaluator batch 16 x 5x5x4, 1/25/100 steps, "
                     "contact off and on; the fused SQP solve's segmented launches "
                     "with growth, 8 x 5x5x4, 8 knots, 75 steps from rest and 25 "
                     "steps at seg_base 75"),
             ms=devo_timed["ms"], plain_ms=devo_timed["plain_ms"],
             ms_of="growth evaluator batch %d x 5x5x4, 25 steps, contact on"
             % devo_timed["batch"]),
        dict(name="K1 trace sampling, NormDistByVol, windows, needle, fall-over (B8c)",
             route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout_common.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:1752",
             launches=featx["fused_rollout_features"] + balx["fused_rollout_features"],
             launches_of="two generations each of the features and ballistic "
             "experiments, every launch with the features",
             **bound_keys(feat_timed["b8c"]),
             max_abs_err=max(max(r.get(k, 0.0) for k in FEAT_SUMS) for r in feat_recs
                             if r["phase"] == "k1_features_vs_plain"),
             err_of=("NormDistByVol, regime and frozen sums, window distances, needle "
                     "position (lattice units; m for the needle) against the plain "
                     "version: evaluator batch 16 x 6^3, contact on, windows of 4 and "
                     "12, 1 and 240 steps; counters, latches and minima equal"),
             ms=feat_timed["b8c"]["ms"], plain_ms=feat_timed["b8c"]["plain_ms"],
             ms_of="evaluator batch 16 x 6^3, 25 steps, contact on, every feature "
             "but sources", added_ms_1024x10_3x200=feat_timed["cost"]["added_ms"]),
        dict(name="K1 environmental sources (B8d)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout_common.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:1078",
             launches=featx["fused_rollout_sources"],
             launches_of="two generations of the features experiment (one source)",
             **bound_keys(feat_timed["b8d"]),
             max_abs_err=max(max(r.get(k, 0.0) for k in ("source_min", "source_sum"))
                             for r in feat_recs if r["phase"] == "k1_features_vs_plain"),
             err_of="source minima and history sums (lattice units), 1 and 3 sources",
             ms=feat_timed["b8d"]["ms"], plain_ms=feat_timed["b8d"]["plain_ms"],
             ms_of="evaluator batch 16 x 6^3, 25 steps, contact on, 3 sources"),
        dict(name="K1 ballistic development (B8b)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout_common.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:1721",
             launches=balx["fused_rollout_ballistic"],
             launches_of="two generations of the ballistic experiment",
             **bound_keys(feat_timed["b8b"]),
             max_abs_err=next(r["devo_err"] for r in feat_recs
                              if r["phase"] == "k1_ballistic_vs_plain"),
             err_of="devo channels 56-59 (m, s), growth batch 16 x 5x5x4, contact on, "
             "240 steps",
             ms=feat_timed["b8b"]["ms"], plain_ms=feat_timed["b8b"]["plain_ms"],
             ms_of="growth evaluator batch 16 x 5x5x4, 25 steps, contact on, windows of 4"),
        _b5_row(mats["b5"], mats["d_cases"], replay["compact"], bound_keys,
                compact_over_dense_1024x10_3x20=mats["cost"]["b5_compact_over_dense"],
                compact_ms_1024x10_3x20=mats["cost"]["b5_compact_ms"],
                dense_ms_1024x10_3x20=mats["cost"]["b5_dense_ms"]),
        dict(name="K1 max-velocity clamp and equilibrium mode (B6a)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout_common.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:1519",
             launches=replay["solver"],
             launches_of="the replay path: the cantilever with the clamp and in "
             "equilibrium mode",
             **bound_keys(mats["b"]),
             max_abs_err=max(max(r["pos"] for r in mats["a"]), mats["b"]["pos"]),
             err_of=("pos (m) against the plain version: the materials batch with the "
                     "clamp, 25/100 steps; bench 8 x 10^3 in equilibrium mode, steps "
                     "400-500 (the zeroing fires at step 478)"),
             ms=mats["b"]["ms"], plain_ms=mats["b"]["plain_ms"],
             ms_of="bench 8 x 10^3, equilibrium mode, 25 steps"),
        dict(name="K1 BC regions (B6b)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout_common.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:966",
             launches=replay["bc"],
             launches_of="the replay path: the cantilever .vxa twice",
             **bound_keys(mats["c"]),
             max_abs_err=mats["c"]["pos"], pinned_exact=mats["c"]["pinned_exact"],
             err_of="pos (m) against the plain version, cantilever 2 x 10^3, 200 steps",
             ms=mats["c"]["ms"], plain_ms=mats["c"]["plain_ms"],
             ms_of="cantilever 2 x 10^3, 25 steps"),
        dict(name="K1 bilinear and MDL_DATA stress, plasticity (B6c)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout_common.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:372",
             launches=matx["fused_rollout_nonlinear"] + swimx["fused_rollout_nonlinear"],
             launches_of="two generations of the materials experiment and of its "
             "swimming twin (%d)" % swimx["fused_rollout_nonlinear"],
             launches_sqp_materials=mat_launches["fused_rollout_material"]
             + sum(v["fused_rollout_material"] for v in sqp_mv.values()),
             **bound_keys(mats["a"][0]),
             max_abs_err=max(r["pos"] for r in mats["a"] + [mats["a_features"]]),
             max_strain_offset_err=max(r["strain_offset_err"]
                                       for r in mats["a"] + [mats["a_features"]]),
             err_of=("pos (m) against the plain version: the materials evaluator batch "
                     "16 x 6^3 with plasticity and the clamp, contact on, 25/100 steps, "
                     "and with the features, 100 steps"),
             ms=mats["a"][0]["ms"], plain_ms=mats["a"][0]["plain_ms"],
             ms_of="materials evaluator batch 16 x 6^3, 25 steps, contact on",
             added_ms_1024x10_3x200=mats["cost"]["b6_added_ms"]),
        dict(name="K1 volume effects (B6d)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout.cu",
             replaces="evosoro_tpu/ops/fused_rollout.py:1178",
             launches=vol["replay_launches"]["volume"] + vol["evolution"]["fused_rollout_volume"]
             + vol["mpc_launches"]["volume"],
             launches_replay=vol["replay_launches"]["volume"],
             launches_evolution=vol["evolution"]["fused_rollout_volume"],
             launches_mpc=vol["mpc_launches"]["volume"],
             launches_of="the volume replay (an archived design and the cantilever), two "
             "generations of the volume experiment, a cold CEM solve with volume effects",
             **bound_keys(vol["b"][0]),
             max_abs_err=max(r["pos"] for r in vol_cases),
             max_ts_err=max(r["ts"] for r in vol_cases),
             max_cs_err=max(r["cs"] for r in vol_cases),
             max_dt_err=max(r["dt"] for r in vol_cases),
             carry_bit_equal=all(r["carry_bit_equal"] for r in vol_cases),
             err_of=("pos (m) against the plain version: the volume design 8 x 4^3, "
                     "1/25/100 steps and with 4 knots; the volume evaluator batch 16 x "
                     "6^3, contact on, 25/100 steps and with the features (each robot "
                     "stopping on its own step); the cantilever 10^3 with volume effects, "
                     "100 steps; the bench 8 x 10^3 with thermal actuation, 25 steps, and "
                     "with 8 knots; the cold CEM solve's first launch (128 x 10^3, 8 "
                     "knots), robots 0-7, 25 steps; beside it the coupling carry (state "
                     "channels 47-52) and the stats dt"),
             ms=vol["b"][0]["ms"], plain_ms=vol["b"][0]["plain_ms"],
             ms_of="volume evaluator batch 16 x 6^3, 25 steps, contact on",
             ms_1024x10_3x200=vol["cost"]["volume_ms"],
             added_ms_1024x10_3x200=vol["cost"]["b6d_added_ms"],
             bound_ms_1024x10_3x200=vol["cost"]["volume_bound_ms"],
             share_of_bound_1024x10_3x200=vol["cost"]["volume_share_of_bound"]),
        dict(name="fma_peak (B9)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fma_peak.cu",
             replaces="tools/roofline.py:137",
             launches=fma["launches"], launches_of="roofline.measure_fp32_peak",
             **bound_keys(fma),
             max_abs_err=fma["max_abs_err"], err_of="sum of 16 chains after %d steps" % fma["iters"],
             ms=fma["ms"], plain_ms=fma["plain_ms"], ms_of=fma["ms_of"],
             measured_fp32_flops_per_s=fma["peak_flops_per_s"]),
    ]))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
