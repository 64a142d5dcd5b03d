#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`evosoro_tpu_torch`) on one card.

Builds the hand-written CUDA kernels from `evosoro_tpu_torch/ops/csrc`,
holds each kernel against its plain PyTorch version, and drives the port's
main paths: two generations of the examples/basic.py evolution experiment
(evaluation through the fused rollout kernel K1 with its in-kernel contact
pass K2), the sampling-MPC benchmark of tools/bench_mpc.py (a cold CEM
solve and a closed receding-horizon loop through K1's control-knot channel),
and its gradient-MPC part (FusedSQPSolver: K1 segments forward, the
reverse-mode segment kernel B4 backward).
It measures the card's FP32 rate with the fma_peak micro-kernel, sets each
kernel's time beside the least time the card could take, and measures the
bench.py throughput workload. Every phase prints one JSON line; any failure
raises and exits non-zero. The last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# tolerances of tests/test_fused_rollout.py:63-78 (fused kernel vs eager step)
TOL = dict(pos=(2e-5, 1e-9), quat=(2e-5, 1e-7), linmom=(1e-4, 1e-10),
           scale=(1e-6, 0.0), time=(1e-6, 0.0))
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
# B4 against autograd through the plain version: every channel group's
# largest error over that group's largest plain value. The two sum the same
# float32 terms in different orders over 25 steps; tests/test_fused_diff.py
# allows the TPU kernel 5e-3 against BPTT
B4_REL_TOL = 2e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


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
    ptxas = {name: [ln.strip() for ln in build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in build.SIGNATURES}
    # fused multiply-adds in each library's machine code: the rollout
    # kernels are built without contraction, fma_peak names the instruction
    ffma = {name: build.sass_count(name, "FFMA") for name in build.SIGNATURES}
    emit(dict(phase="build", seconds=secs, ptxas=ptxas, sass_ffma=ffma))
    assert ffma["fma_peak"] >= 16, ffma


def _event_ms(torch, fn, reps):
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


def _compare(torch, fr, out_k, st_k, out_p, st_p):
    def ch(x, a, b):
        return x[:, a:b, :]

    errs, ok = {}, True
    for name, (a, b) in dict(pos=(fr._POS, fr._POS + 3),
                             quat=(fr._QUAT, fr._QUAT + 4),
                             linmom=(fr._LIN, fr._LIN + 3),
                             scale=(fr._SCALE, fr._SCALE + 1)).items():
        rtol, atol = TOL[name]
        k, p = ch(out_k, a, b), ch(out_p, a, b)
        d = (k - p).abs()
        errs[name] = float(d.max())
        ok &= bool((d <= atol + rtol * p.abs()).all())
    tk, tp = st_k[:, fr._S_TIME], st_p[:, fr._S_TIME]
    errs["time"] = float((tk - tp).abs().max())
    ok &= bool(((tk - tp).abs() <= TOL["time"][0] * tp.abs()).all())
    same_small = bool(torch.equal(ch(out_k, fr._SMALL, fr._SMALL + 3),
                                  ch(out_p, fr._SMALL, fr._SMALL + 3)))
    errs["small_angle_equal"] = same_small
    errs["ini_cm"] = float((st_k[:, fr._S_INICM:fr._S_INICM + 3]
                            - st_p[:, fr._S_INICM:fr._S_INICM + 3]).abs().max())
    return ok and same_small, errs


def _k1_cases(torch, fr, label, args, kw, batch, coll, steps_list, time_at=None,
              phase="k1_vs_plain", **extra):
    """K1 against its plain version on one input (`kw` may carry controls);
    returns the records, with `extra` in each."""
    from evosoro_tpu_torch import roofline

    recs = []
    for steps in steps_list:
        before = fr.FUSED_ROLLOUT_LAUNCHES
        out_k, st_k = fr.fused_call(*args, num_steps=steps, **kw)
        torch.cuda.synchronize()
        assert fr.FUSED_ROLLOUT_LAUNCHES == before + 1
        out_p, st_p = fr.fused_rollout_plain(*args, num_steps=steps, **kw)
        torch.cuda.synchronize()
        ok, errs = _compare(torch, fr, out_k, st_k, out_p, st_p)
        rec = dict(phase=phase, workload=label, batch=batch, steps=steps,
                   collision=coll, **extra, **errs)
        if steps == 100:
            # beyond the step-level tolerances: drift against the band
            rec.update(drift_bound_m=DRIFT_BOUND_M)
            ok = errs["pos"] <= DRIFT_BOUND_M
        if steps == time_at:
            rec["ms"] = _event_ms(
                torch, lambda: fr.fused_call(*args, num_steps=steps, **kw), 5)
            rec["plain_ms"] = _event_ms(
                torch, lambda: fr.fused_rollout_plain(*args, num_steps=steps, **kw), 1)
            rec.update(roofline.bound(*roofline.k1_work(
                *args, st_k, kw.get("control_packed"))))
        rec["ok"] = ok
        emit(rec)
        assert ok, rec
        recs.append(rec)
    return recs


def phase_k1(torch):
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
                              time_at=25 if coll and not stagger else None)
    return recs


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


def phase_k1_knots(torch, np):
    """K1's control-knot channel against the plain version: K in {1, 4},
    1/25/100 steps, contact off and on, on both workloads. Then the guard in
    the data: with only robot 1's knots non-zero every other robot must come
    out of the launch as it does with no knots at all, bit for bit."""
    from evosoro_tpu_torch.ops import fused_rollout as fr

    recs = []
    for label, args, kw, coll in _knot_workloads():
        B, _, V = args[0].shape
        for K in (1, 4):
            u = _controls(torch, np, B, K, V, seed=K)
            recs += _k1_cases(torch, fr, label, args,
                              dict(kw, control_packed=u, n_knots=K), B, coll,
                              (1, 25, 100), phase="k1_knots_vs_plain", knots=K)
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
                   vs_plain=errs, ok=ok)
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
             zero_cot=False, timed=False):
    """B4 against `fused_bwd_plain` on one input, with the two guards in the
    data: a launch one step short and the controls' cotangent moved to the
    neighbouring knot must both fail the comparison."""
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
    if timed:
        rec["ms"] = _event_ms(torch, lambda: fr.fused_bwd_call(
            state, body, stats, ctrl, seg_base, cot, **kw), 5)
        rec["plain_ms"] = _event_ms(torch, lambda: fr.fused_bwd_plain(
            state, body, stats, ctrl, seg_base, cot, **kw), 1)
        rec["k1_ms"] = _event_ms(torch, lambda: fr.fused_call(
            state, body, stats, None, control_packed=ctrl, seg_base=seg_base, **kw), 5)
        _, st_end = fr.fused_call(state, body, stats, None, control_packed=ctrl,
                                  seg_base=seg_base, **kw)
        steps = torch.round((st_end[:, fr._S_TIME] - stats[:, fr._S_TIME])
                            / stats[:, fr._S_DT])
        rec["steps_taken"] = steps.tolist()
        rec.update(roofline.bound(*roofline.b4_work(state, body, stats, ctrl, steps)))
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


def phase_evolution(torch):
    from evosoro_tpu_torch.bench import evolution
    from evosoro_tpu_torch.ops import fused_rollout as fr

    fr.FUSED_ROLLOUT_LAUNCHES = 0
    fr.FUSED_ROLLOUT_CONTACT_LAUNCHES = 0
    fr.FUSED_ROLLOUT_KNOT_LAUNCHES = 0
    fr.PAIR_CONTACT_LAUNCHES = 0
    records = evolution(gens=2, pop_size=15, device="cuda")
    launches = dict(fused_rollout=fr.FUSED_ROLLOUT_LAUNCHES,
                    fused_rollout_with_contact=fr.FUSED_ROLLOUT_CONTACT_LAUNCHES,
                    fused_rollout_with_knots=fr.FUSED_ROLLOUT_KNOT_LAUNCHES,
                    pair_contact=fr.PAIR_CONTACT_LAUNCHES)
    import math

    for r in records:
        fits = r.pop("fitnesses")
        # invalid and diverged designs get the objective's worst value, -10e6
        valid = [f for f in fits if f > -1e6]
        r.update(phase="evolution", n_evaluated_valid=len(valid),
                 all_finite=all(math.isfinite(f) for f in fits))
        emit(r)
        assert r["k1_launches"] > 0, r
        assert r["all_finite"], r
        assert valid, "every design was invalid or diverged"
    # K2's routine runs inside K1's launches; its own kernel is not on the path
    assert launches["fused_rollout"] > 0, launches
    assert launches["fused_rollout_with_contact"] > 0, launches
    emit(dict(phase="evolution_launches", **launches))
    return launches


def phase_throughput(torch, card):
    from evosoro_tpu_torch.bench import throughput

    recs = dict(
        k1=throughput(batch=1024, steps=200, groups=4, reps=3),
        k1_20=throughput(batch=1024, steps=20, groups=4, reps=3),
        plain_20=throughput(batch=1024, steps=20, plain=True, groups=1, reps=1),
        k1_coll=throughput(batch=1024, steps=20, collision=True, groups=2, reps=2),
        plain_coll=throughput(batch=1024, steps=5, collision=True, plain=True,
                              groups=1, reps=1),
    )
    for r in recs.values():
        emit(dict(phase="throughput", card=card, **r))
    return recs


def main():
    if not os.path.isdir(os.path.join(HERE, "evosoro_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository "
                         "(evosoro_tpu_torch/ not found beside it)")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    card = phase_device(torch)
    phase_build()
    k2 = phase_k2(torch, np)
    k1 = phase_k1(torch)
    knots = phase_k1_knots(torch, np)
    phase_k1_segmented(torch, np)
    fma = phase_fp32_peak(torch)
    launches = phase_evolution(torch)
    mpc_launches, knot_timed, loop_recs = phase_mpc(torch, np)
    b4 = phase_b4(torch, np)
    b4_timed = next(r for r in b4 if "ms" in r)
    sqp_launches = phase_sqp(torch, b4_timed)
    phase_throughput(torch, card)
    k1_timed = next(r for r in k1 if "ms" in r)
    knots += [knot_timed, *loop_recs]

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
             launches=launches["fused_rollout"] + mpc_launches["fused_rollout"]
             + sqp_launches["fused_rollout"],
             launches_evolution=launches["fused_rollout"],
             launches_mpc=mpc_launches["fused_rollout"],
             launches_sqp=sqp_launches["fused_rollout"],
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
             k1_launches_with_contact=launches["fused_rollout_with_contact"],
             max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             err_of="force (N), own launch, %s %s, table %s"
             % (k2["workload"], k2["shape"], k2["table_shape"]),
             ms_of="own launch, same input"),
        dict(name="K1 control knots + segments (B3)", route="cuda",
             source="evosoro_tpu_torch/ops/csrc/fused_rollout.cu",
             replaces="evosoro_tpu/ops/fused_rollout.py:1710",
             launches=mpc_launches["fused_rollout_with_knots"]
             + sqp_launches["fused_rollout_with_knots"],
             launches_evolution=launches["fused_rollout_with_knots"],
             launches_sqp=sqp_launches["fused_rollout_with_knots"],
             **bound_keys(knot_timed),
             max_abs_err=max(r["pos"] for r in knots),
             err_of=("pos (m), bench 8 x 10^3 and evaluator batch 16 x 6^3, "
                     "K 1 and 4, 1/25/100 steps, contact off and on; the "
                     "solve's launch, 128 x 10^3, 8 knots, 200 steps; and the "
                     "closed loop's plan (32 x 200 steps, 8 knots) and execute "
                     "(1 x 100 steps, 4 knots) launches after a segment"),
             ms=knot_timed["ms"], plain_ms=knot_timed["plain_ms"],
             ms_of="one launch of a cold solve: 128 x 10^3, 8 knots, 200 steps"),
        dict(name="fused_rollout_bwd (B4)", route="cuda",
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
             ms_of="one launch of a solve: 8 x 10^3, 25 steps at seg_base 75, 8 knots"),
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
