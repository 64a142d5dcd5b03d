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
and with the voxel-face drag, and with growth.
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
(`phase_b4_variants`), then `bench.sqp` on land
and in each variant (`phase_sqp`, `phase_sqp_variants`); its kernels line
holds B4's rows.

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

`python3 chip_smoke.py --volume` runs volume effects alone
(`phase_k1_volume`): K1's volume instance against its plain version with
its three guards, the volume replay of an archived design and of the
cantilever, two generations of the volume experiment, a cold CEM solve
with volume effects and the volume throughput in turns with the land and
material instances.
"""

from __future__ import annotations

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
    # fused multiply-adds in each library's machine code: the rollout
    # kernels are built without contraction, fma_peak names the instruction
    ffma = {name: build.sass_count(name, "FFMA") for name in build.SIGNATURES}
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
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out_p, st_p = fr.fused_rollout_plain(*args, num_steps=steps, **kw)
        b.record()
        torch.cuda.synchronize()
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
            rec["plain_ms"] = a.elapsed_time(b)  # the comparison's own call
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
        out_p, st_p = fr.fused_rollout_plain(*cargs, num_steps=steps, **kw)
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
                                     (1, 25, 100), **opts)
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
        out_p, st_p = fr.fused_rollout_plain(*args, num_steps=100, **kw)
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
            out_p, st_p = fr.fused_rollout_plain(*args, num_steps=steps, **kw)
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
    out_p, st_p = fr.fused_rollout_plain(*args, num_steps=steps, **kw)
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
    out_p, st_p = fr.fused_rollout_plain(*args_w, num_steps=100, **kw_w)
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

    # the shared-memory ceiling with contact: a 1350-cell body launches the
    # feature instance (its static shared memory is the largest) in shared
    # memory, 1351 its device-memory twin; both against the plain version
    rec = dict(phase="k1_ceiling", device_launches={}, errs={})
    for V in (1350, 1351):
        a, k = _line_workload(torch, fr, V)
        g0 = fr.FUSED_ROLLOUT_GMEM_LAUNCHES
        out_k, st_k = fr.fused_call(*a, num_steps=25, **k)
        torch.cuda.synchronize()
        rec["device_launches"][V] = fr.FUSED_ROLLOUT_GMEM_LAUNCHES - g0
        ok, rec["errs"][V] = _compare(torch, fr, out_k, st_k,
                                      *fr.fused_rollout_plain(*a, num_steps=25, **k))
        assert ok, rec
    emit(rec)
    assert rec["device_launches"] == {1350: 0, 1351: 1}, rec

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
    out_p, st_p = fr.fused_rollout_plain(*args, num_steps=steps, **kw)
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


def _compact_case(torch, np, fr, label, a_c, kw_c, a_d, kw_d, time_steps=None):
    """K1's compact contact pass against its plain version and against the
    dense pass, on launches `a_c` (compact table) and `a_d` (dense table)
    of one design whose lattice is shrunk about its centre so that far
    surface voxels touch: one step (its momenta carry the contact forces
    times dt, and the launches differ only in the order of the pair sums),
    held to K2's rule max |df| <= 1e-4 max |f|; contact off must fail.
    Returns the record, with the dense comparison under `dense_vs_compact`."""
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
    out_c, st_c = fr.fused_call(*a_c, num_steps=1, **kw_c)
    out_d, st_d = fr.fused_call(*a_d, num_steps=1, **kw_d)
    ok, errs = _compare(torch, fr, out_c, st_c, out_d, st_d, no_lin)
    rec_cd = dict(phase="compact_vs_dense_k1", workload=label, steps=1, **errs)
    ok &= force_check(rec_cd, out_c, st_c, out_d, st_d)
    rec_cd["ok"] = ok
    emit(rec_cd)
    assert ok, rec_cd
    return dict(rec, dense_vs_compact=rec_cd)


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
    recs["d"] = []
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
        # version and the dense pass
        k1 = _compact_case(torch, np, fr, "fixture %s shrunk into contact, compact contact"
                           % name, a_c, kw_c, a_d, kw_d)
        rec = dict(phase="replay", file=name, steps=dense["steps"],
                   fitness_dense=dense["fitness"], fitness_compact=compact["fitness"],
                   fitness_rel_diff=fit_rel, fitness_in_file_name=dense["fitness_in_name"],
                   seconds_dense=dense["seconds"], seconds_compact=compact["seconds"],
                   surface_voxels=dense["surface_voxels"], voxels=dense["voxels"],
                   contact_force_max=fmax, compact_vs_dense_rel=rel,
                   k1_momentum_rel_err=k1["momentum_rel_err"],
                   k1_momentum_rel_err_vs_dense=k1["dense_vs_compact"]["momentum_rel_err"],
                   tol=K2_REL_TOL)
        ok = (fmax > 0 and rel <= K2_REL_TOL and fit_rel <= K2_REL_TOL
              and not dense["diverged"] and not compact["diverged"]
              and all(np.isfinite([dense["fitness"], compact["fitness"]])))
        rec["ok"] = ok
        emit(rec)
        assert ok, rec
        recs["d"].append(rec)
    # the same on the bench 10^3 design (488 surface voxels), 4 robots,
    # timed at 25 steps from the same state
    a_c, kw_c, _ = bench.packed_workload(4, collision=True, compact=True, device="cuda")
    a_d, kw_d, _ = bench.packed_workload(4, collision=True, device="cuda")
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
    out_p, st_p = fr.fused_rollout_plain(*args, num_steps=steps, **kw)
    torch.cuda.synchronize()
    ok, errs = _vol_check(torch, fr, out_k, st_k, out_p, st_p)
    rec = dict(phase="k1_volume_vs_plain", workload=label, batch=args[0].shape[0],
               steps=steps, tol=dict(VOL_TOL, ts=VOL_TS, cs=VOL_CS, dt=VOL_DT_RTOL),
               **info, **errs)
    for name, checks, (fn_name, fn) in guards:
        with mock.patch.object(step_mod, fn_name, fn):
            out_g, st_g = fr.fused_rollout_plain(*args, num_steps=steps, **kw)
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
             ("_volume_dt", lambda state, body, sim, bonds, L, dt: dt)),
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
            st_p, ss_p = fr.fused_rollout_plain(st_p, body, ss_p, table, num_steps=8,
                                                seg_base=base, **seg_kw)
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
    ref = fr.fused_bwd_plain(state, body, stats, ctrl, seg_base, cot, **kw)
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
        rec["ms"] = _event_ms(torch, lambda: fr.fused_bwd_call(
            state, body, stats, ctrl, seg_base, cot, **kw), 5)
        rec["plain_ms"] = _event_ms(torch, lambda: fr.fused_bwd_plain(
            state, body, stats, ctrl, seg_base, cot, **kw), 1, warm=False)
        rec["k1_ms"] = _event_ms(torch, lambda: fr.fused_call(
            state, body, stats, None, control_packed=ctrl, seg_base=seg_base, **kw), 5)
        _, st_end = fr.fused_call(state, body, stats, None, control_packed=ctrl,
                                  seg_base=seg_base, **kw)
        steps = torch.round((st_end[:, fr._S_TIME] - stats[:, fr._S_TIME])
                            / stats[:, fr._S_DT])
        rec["steps_taken"] = steps.tolist()
        flags = kw["flags"]
        land = not (flags.get("fluid") or any(flags.get(k) for k in fr._K1_DEVO_FLAGS))
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
    rest and from the state K1 reaches 75 steps in under random controls
    (timed), with a random cotangent; then each variant's guards
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
        out_p, st_p = fr.fused_rollout_plain(*seg, num_steps=S, **dict(k1_kw, seg_base=75))
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
    (20 steps, 2 CG iterations) and two `grad_optimize` iterations at 25
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

    # the plain path on the card, cut in depth: 20 and 25 steps of the 200
    body, sim, _, dt = bench.mpc_workload(device="cuda")
    env = EnvParams(gravity_enabled=False, floor_enabled=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, info = sqp_optimize(body, sim, env, 20, 8, target=0.4,
                           config=SQPConfig(num_iters=1, cg_iters=2, n_res=8),
                           dt=dt, device="cuda")
    costs = info["cost_trace"].tolist() + [float(info["final_cost"])]
    emit(dict(phase="sqp", what="one sqp_optimize iteration, eager rollout, "
              "forward- and reverse-mode products", steps=20, steps_cut_from=200,
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
                                         "ballistic", "materials")):
    """Two generations each of the basic, swimming and growth experiments and
    of their feature twins (basic with NormDistByVol, the fall-over latch,
    speed windows and a source; growth with ballistic development), of the
    materials experiment and of the volume experiment (basic with volume
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
            if experiment == "swimming":
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
            if experiment == "materials":
                assert r["k1_material_launches"] == r["k1_launches"], r
            if experiment == "volume":
                assert r["k1_volume_launches"] == r["k1_launches"], r
        # K2's routine runs inside K1's launches; its own kernel is not on the path
        assert launches["fused_rollout"] > 0, launches
        assert launches["fused_rollout_with_contact"] > 0, launches
        if experiment == "swimming":  # the default drag model is the facet drag
            assert launches["fused_rollout_mesh"] == launches["fused_rollout_fluid"] \
                == launches["fused_rollout"], launches
        elif experiment in ("growth", "ballistic"):
            assert launches["fused_rollout_devo"] == launches["fused_rollout"], launches
        else:
            assert launches["fused_rollout_fluid"] == launches["fused_rollout_devo"] == 0
        features = experiment in ("features", "ballistic")
        assert (launches["fused_rollout_features"] == launches["fused_rollout"]) == features
        assert (launches["fused_rollout_ballistic"] > 0) == (experiment == "ballistic")
        materials = experiment in ("materials", "volume")
        assert (launches["fused_rollout_material"] == launches["fused_rollout"]) == materials
        assert (launches["fused_rollout_nonlinear"] > 0) == (experiment == "materials")
        assert (launches["fused_rollout_volume"] == launches["fused_rollout"]) \
            == (experiment == "volume")
        emit(dict(phase="evolution_launches", experiment=experiment, **launches))
        all_launches[experiment] = launches
    return all_launches


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
                    "version: the SQP launch %s x 25 steps, 8 knots, from rest and 75 "
                    "steps in, and the guards' launch; worst_rel_err as the land row"
                    % recs[0]["workload"].split(", ")[0][len("SQP launch "):]),
            ms=timed["ms"], plain_ms=timed["plain_ms"],
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


def _sqp_k1_launch(torch, np, fr, n=10, B=8, K=8, **wkw):
    """K1's launch of the fused SQP solve on `bench.sqp_workload(n, **wkw)`
    from rest: segmented mode on a 200-step clock, seg_base 0, `K` knots of
    random controls. Returns (args, launch keywords without num_steps)."""
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.core.rollout import init_state

    body, sim, env, dt = bench.sqp_workload(n=n, device="cuda", **wkw)
    state0 = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
    kw = dict(grid_shape=tuple(body.occ.shape),
              scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=fr.launch_flags(body, sim, env, collision=False, segmented=True),
              n_knots=K, total_steps=200,
              control_packed=_controls(torch, np, B, K, body.occ.numel(), seed=31),
              seg_base=0)
    return (state0, fr.pack_body(body), fr.make_stats(body, B, dt, sim, env), None), kw


def _sqp_b4_launch(torch, np, fr, n=10, B=8, K=8, **wkw):
    """B4's launch of the fused SQP solve on `bench.sqp_workload(n, **wkw)`:
    25 steps of a 200-step clock from the state K1 reaches 75 steps in under
    random controls (`_sqp_k1_launch`), with a random cotangent. Returns
    (state, body, stats, controls, cotangent, launch keywords)."""
    args, kw = _sqp_k1_launch(torch, np, fr, n, B, K, **wkw)
    st75, ss75 = fr.fused_call(*args, num_steps=75, **kw)
    cot = np.random.default_rng(32).standard_normal(st75.shape).astype(np.float32)
    cot[:, fr._TSAVG:] = 0.0
    ctrl = kw.pop("control_packed")
    kw.pop("seg_base")
    return (st75, args[1], ss75, ctrl, torch.as_tensor(cot, device="cuda"),
            dict(kw, num_steps=25))


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
    (kept by `_keeping_launch`): the 12^3 cantilever's replay, the cold CEM
    solve's first launch and the SQP solve's first segment past seg_base 0.
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
    sq_args, sq_kw = _sqp_k1_launch(torch, np, fr)
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
        st, bo, ss, ctrl, cot, kw = _sqp_b4_launch(torch, np, fr, **wkw)
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
    sq_args, sq_kw = _sqp_k1_launch(torch, np, fr, n=12)
    k1 += _k1_cases(torch, fr, "SQP launch 8 x 12^3, segmented, 8 knots, from rest", sq_args,
                    sq_kw, 8, False, (75,), phase="big_vs_plain", n=12)
    out["k1"] = k1
    st, bo, ss, ctrl, cot, kw = _sqp_b4_launch(torch, np, fr, n=12)
    b0 = fr.FUSED_BWD_GMEM_LAUNCHES
    out["b4"] = _b4_case(torch, np, fr, "SQP launch 8 x 12^3, no floor, no gravity, 75 steps "
                         "in", st, bo, ss, ctrl, 75, kw, seed=9, timed=True)
    assert fr.FUSED_BWD_GMEM_LAUNCHES > b0

    # (c) the guard: every robot handed robot 0's buffer
    args, kw = big12
    out_p, st_p = fr.fused_rollout_plain(*args, num_steps=25, **kw)
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
    for label, kept, tol in (
            ("12^3 cantilever's replay launch (BC channels, the clamp)", kept_replay,
             _strictest("bc", "max_vel")),
            ("cold CEM solve's first launch", kept_mpc, TOL),
            ("fused SQP solve's first segment past seg_base 0", kept_sqp, TOL)):
        (args, kw, steps), = kept
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
                     "main paths' own launches: the 12^3 cantilever's replay whole, the "
                     "cold CEM solve's first launch (128 x 12^3, 8 knots, 200 steps), the "
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
    if sys.argv[1:] == ["--diff"]:
        b4 = phase_b4(torch, np)
        b4_var, k1_sqp = phase_b4_variants(torch, np)
        sqp_launches = phase_sqp(torch, next(r for r in b4 if "ms" in r))
        var_launches = phase_sqp_variants(torch, b4_var)

        def bound_keys(rec):
            return dict(bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None)

        emit(dict(kernels=_b4_rows(b4, b4_var, sqp_launches, var_launches, bound_keys)))
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
    k1 = phase_k1(torch)
    knots = phase_k1_knots(torch, np, (1, 25))
    phase_k1_segmented(torch, np)
    fluid = phase_k1_fluid(torch)
    devo = phase_k1_devo(torch)
    feat_recs, feat_timed = phase_k1_features(torch)
    replay, replays = phase_replay(torch)
    mats = phase_k1_materials(torch, np, replays)
    vol = phase_k1_volume(torch, np, replays)
    fma = phase_fp32_peak(torch)
    evo_launches = phase_evolution(torch)
    launches = evo_launches["basic"]
    swim, grow = evo_launches["swimming"], evo_launches["growth"]
    featx, balx = evo_launches["features"], evo_launches["ballistic"]
    matx = evo_launches["materials"]
    mpc_launches, knot_timed, loop_recs = phase_mpc(torch, np)
    b4 = phase_b4(torch, np)
    b4_timed = next(r for r in b4 if "ms" in r)
    b4_var, k1_sqp = phase_b4_variants(torch, np)
    sqp_launches = phase_sqp(torch, b4_timed)
    var_launches = phase_sqp_variants(torch, b4_var)
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
             + vol["replay_launches"]["fused_rollout"] + vol["evolution"]["fused_rollout"]
             + vol["mpc_launches"]["fused_rollout"] + big_k1,
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
             launches_volume=vol["replay_launches"]["fused_rollout"]
             + vol["evolution"]["fused_rollout"] + vol["mpc_launches"]["fused_rollout"],
             launches_big_bodies=big_k1,
             **bound_keys(k1_timed),
             max_abs_err=max(r["pos"] for r in k1),
             err_of=("pos (m), evaluator batch %d x 6^3, 1/25/100 steps, "
                     "contact off and on, as packed and with dt/stop/IniCM per robot"
                     % k1_timed["batch"]),
             ms=k1_timed["ms"], plain_ms=k1_timed["plain_ms"],
             ms_of="evaluator batch %d x 6^3, 25 steps, contact on"
             % k1_timed["batch"]),
        dict(name="pair_contact_forces (K2)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/pair_contact.cu",
             replaces="evosoro_tpu/ops/fused_rollout.py:672",
             launches=launches["pair_contact"] + mpc_launches["pair_contact"],
             runs_inside="fused_rollout (K1)",
             **bound_keys(k2),
             k1_launches_with_contact=launches["fused_rollout_with_contact"]
             + swim["fused_rollout_with_contact"] + grow["fused_rollout_with_contact"],
             max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             err_of="force (N), own launch, %s %s, table %s"
             % (k2["workload"], k2["shape"], k2["table_shape"]),
             ms_of="own launch, same input"),
        dict(name="K1 control knots + segments (B3)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout.cu",
             replaces="evosoro_tpu/ops/fused_rollout.py:1710",
             launches=mpc_launches["fused_rollout_with_knots"]
             + sqp_launches["fused_rollout_with_knots"]
             + sum(v["fused_rollout_with_knots"] for v in var_launches.values()),
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
             ms_of="one launch of a cold solve: 128 x 10^3, 8 knots, 200 steps"),
        *_b4_rows(b4, b4_var, sqp_launches, var_launches, bound_keys),
        *_big_rows(big, bound_keys),
        dict(name="K1 fluid branches (B7)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout_common.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:1373",
             launches=swim["fused_rollout_fluid"] + var_launches["mesh"]["fused_rollout_fluid"]
             + var_launches["face"]["fused_rollout_fluid"],
             launches_of="two generations of the swimming experiment, every "
             "launch with the facet drag (%d); bench.sqp in water, facet and "
             "voxel-face drag (%d, %d)" % (swim["fused_rollout_mesh"],
                                          var_launches["mesh"]["fused_rollout_fluid"],
                                          var_launches["face"]["fused_rollout_fluid"]),
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
             launches=grow["fused_rollout_devo"] + var_launches["devo"]["fused_rollout_devo"],
             launches_of="two generations of the growth experiment, and bench.sqp "
             "with growth (%d)" % var_launches["devo"]["fused_rollout_devo"],
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
        dict(name="K1 surface-compacted contact pass (B5)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/pair_contact.cuh",
             replaces="evosoro_tpu/ops/fused_rollout.py:734",
             launches=replay["compact"],
             launches_of="the replay path: the four fixtures with the compact switch",
             **bound_keys(mats["b5"]),
             max_abs_err=mats["b5"]["linmom"],
             momentum_rel_err=max([mats["b5"]["momentum_rel_err"]]
                                  + [r["k1_momentum_rel_err"] for r in mats["d"]]),
             momentum_rel_err_vs_dense=max(
                 [mats["b5"]["dense_vs_compact"]["momentum_rel_err"]]
                 + [r["k1_momentum_rel_err_vs_dense"] for r in mats["d"]]),
             max_rel_force_err_vs_dense=max(r["compact_vs_dense_rel"] for r in mats["d"]),
             err_of=("momentum (kg m/s) of K1 with the compact pass against its plain "
                     "version, bench 4 x 10^3 shrunk into contact, 1 step; the relative "
                     "momentum errors against the plain version and the dense K1 also "
                     "over each fixture's lattice shrunk into contact; and the compact "
                     "plain pass against the dense K2 there (max|df| / max|f|)"),
             ms=mats["b5"]["ms"], plain_ms=mats["b5"]["plain_ms"],
             ms_of="K1 launch with the compact pass, bench 4 x 10^3 shrunk into "
             "contact, 25 steps",
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
             launches=matx["fused_rollout_nonlinear"],
             launches_of="two generations of the materials experiment",
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
