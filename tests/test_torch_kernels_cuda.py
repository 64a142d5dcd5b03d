"""The port's CUDA kernels against their plain PyTorch versions on the card.

Imports torch only, so it runs on a machine with a card and no JAX:
`python -m pytest -m cuda tests/test_torch_kernels_cuda.py`. Elsewhere it
skips: the kernels have no CPU mode.
"""

import pytest
import torch

from evosoro_tpu_torch.ops import fused_rollout as fr


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """K1 (with and without the contact pass) and K2 against their plain
    versions, at the step-level tolerances of tests/test_fused_rollout.py,
    on the bench design and on the evaluator's own batch (a body, pair table
    and dt per robot, stop and IniCM times staggered per robot)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch.bench import evaluator_workload, packed_workload

    for coll in (False, True):
        workloads = [packed_workload(8, n=6, collision=coll, device="cuda")[:2],
                     evaluator_workload(collision=coll, stagger=True, device="cuda")]
        for args, kw in workloads:
            for steps in (25, 100):
                out_k, st_k = fr.fused_call(*args, num_steps=steps, **kw)
                out_p, st_p = fr.fused_rollout_plain(*args, num_steps=steps, **kw)
                torch.testing.assert_close(out_k, out_p, rtol=2e-5, atol=1e-7)
                torch.testing.assert_close(st_k, st_p, rtol=1e-5, atol=1e-7)
    pos = torch.rand(4, 3, 216, device="cuda") * 0.03
    scale = torch.full((4, 216), 0.01, device="cuda")
    for a1 in (torch.rand(1, 216, 216, device="cuda") * 1e4,
               torch.rand(4, 216, 216, device="cuda") * 1e4):
        f_k = fr.pair_contact_forces(pos, scale, a1)
        f_p = fr.pair_contact_forces_plain(pos, scale, a1)
        assert (f_k - f_p).abs().max() <= 1e-4 * f_p.abs().max()


def _controls(batch, knots, voxels, seed):
    g = torch.Generator().manual_seed(seed)
    return ((torch.rand(batch, knots, voxels, generator=g) - 0.5) * 0.1).cuda()


@pytest.mark.cuda
def test_knot_channel_and_segments_match_plain_on_the_card():
    """K1's control-knot channel (K 1 and 4, controls different per robot)
    against the plain version at the same tolerances, the one-robot guard,
    and three segmented launches against one whole launch, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch.bench import evaluator_workload, packed_workload

    for coll in (False, True):
        workloads = [packed_workload(8, n=6, collision=coll, device="cuda")[:2],
                     evaluator_workload(collision=coll, device="cuda")]
        for args, kw in workloads:
            B, _, V = args[0].shape
            for K in (1, 4):
                ckw = dict(kw, control_packed=_controls(B, K, V, K), n_knots=K)
                for steps in (25, 100):
                    out_k, st_k = fr.fused_call(*args, num_steps=steps, **ckw)
                    out_p, st_p = fr.fused_rollout_plain(*args, num_steps=steps, **ckw)
                    torch.testing.assert_close(out_k, out_p, rtol=2e-5, atol=1e-7)
                    torch.testing.assert_close(st_k, st_p, rtol=1e-5, atol=1e-7)
            u = _controls(B, 4, V, 9)
            others = torch.arange(B, device="cuda") != 1
            u[others] = 0.0
            one, _ = fr.fused_call(*args, num_steps=25, control_packed=u, n_knots=4, **kw)
            none, _ = fr.fused_call(*args, num_steps=25, **kw)
            assert torch.equal(one[others], none[others])
            assert not torch.equal(one[1], none[1])

            ckw = dict(kw, control_packed=_controls(B, 4, V, 3), n_knots=4)
            whole, whole_st = fr.fused_call(*args, num_steps=24, **ckw)
            seg_kw = dict(ckw, flags=dict(kw["flags"], segmented=True), total_steps=24)
            st, ss = args[0], args[2]
            for base in (0, 8, 16):
                st, ss = fr.fused_call(st, args[1], ss, args[3], num_steps=8,
                                       seg_base=base, **seg_kw)
            assert torch.equal(st, whole) and torch.equal(ss, whole_st)


@pytest.mark.cuda
def test_closed_loop_launches_match_plain_on_the_card():
    """The closed MPC loop's two K1 launches on what the loop hands them
    after an executed segment, against the plain version at the same
    tolerances: the plan (the true state broadcast to the candidates) and the
    execution (one robot, its carried stats row, the knot clock restarted)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch.bench import mpc_workload
    from evosoro_tpu_torch.control import CEMConfig, make_fused_mpc_closed_loop
    from evosoro_tpu_torch.control.shooting import plan_inputs

    body, sim, env, dt = mpc_workload(n=6, device="cuda")
    run, aux = make_fused_mpc_closed_loop(
        body, sim, env, 40, 8, exec_knots=4,
        config=CEMConfig(num_iters=1, pop_size=8), dt=dt, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    state, stats, _ = run(gen, 1, aux["state"], aux["stats"],
                          torch.zeros(aux["shape"], device="cuda"),
                          torch.full(aux["shape"], 0.02, device="cuda"))
    runner = aux["runner"]
    plan_state, plan_stats = plan_inputs(state, stats, aux["P"])
    for (st, ss), kw, batch, k in (((plan_state, plan_stats), aux["plan_kwargs"], 8, 8),
                                   ((state, stats), aux["exec_kwargs"], 1, 4)):
        args = (st, runner.body_packed, ss, runner.collision_packed)
        kw = dict(kw, control_packed=_controls(batch, k, 216, 6))
        out_k, st_k = fr.fused_call(*args, **kw)
        out_p, st_p = fr.fused_rollout_plain(*args, **kw)
        torch.testing.assert_close(out_k, out_p, rtol=2e-5, atol=1e-7)
        torch.testing.assert_close(st_k, st_p, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_fma_peak_matches_plain_on_the_card():
    """The FP32 multiply-add micro-kernel against its plain version, which
    rounds once a step as a fused multiply-add does: 4096 steps (they move a
    chain by 4.9e-4) at 4 float32 ulps on the sum (2^-21), nearly every sum
    equal bit for bit, and a launch 16 steps short outside the tolerance.
    Then a peak reading no card can exceed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch import roofline

    x = torch.rand(1 << 16, device="cuda") + 0.5
    ref = roofline.fma_chains_plain(x, 4096)
    out = roofline.fma_chains(x, 4096)
    torch.testing.assert_close(out, ref, rtol=2.0 ** -21, atol=0)
    assert (out == ref).float().mean() >= 0.999
    short = roofline.fma_chains(x, 4096 - 16)
    assert ((short - ref).abs() / ref.abs()).max() > 2.0 ** -21
    peak = roofline.measure_fp32_peak(iters=4096)
    assert 0 < peak["flops_per_s"] <= 1.05 * roofline.H100_FP32_FLOPS


@pytest.mark.cuda
def test_reverse_mode_segment_matches_plain_on_the_card():
    """B4 against `fused_bwd_plain` (torch autograd through the plain
    version) with a random cotangent on every carried channel, on the bench
    design (6^3, a shared body, without and with floor and gravity) and on
    the evaluator's designs (a body per robot), from rest and from the state
    a segment in: every channel group within 2e-3 of the group's largest
    plain value; a zero cotangent gives zeros; and `DiffRollout`'s gradient
    of the last boundary's CoM-y equals the plain path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch.bench import evaluator_workload, mpc_workload
    from evosoro_tpu_torch.core.rollout import init_state
    from evosoro_tpu_torch.core.types import EnvParams
    from evosoro_tpu_torch.ops.fused_diff import DiffRollout

    groups = dict(pos=(0, 3), quat=(3, 7), linmom=(7, 10), angmom=(10, 13),
                  scale=(13, 14), memory=(17, 44), max_strain=(44, 47))

    def check(state, body, stats, ctrl, base, kw, seed):
        g = torch.Generator().manual_seed(seed)
        cot = torch.randn(state.shape, generator=g).cuda()
        cot[:, fr._TSAVG:] = 0.0
        before = fr.FUSED_BWD_LAUNCHES
        cs_k, cu_k = fr.fused_bwd_call(state, body, stats, ctrl, base, cot, **kw)
        assert fr.FUSED_BWD_LAUNCHES == before + 1
        cs_p, cu_p = fr.fused_bwd_plain(state, body, stats, ctrl, base, cot, **kw)
        for a, b in groups.values():
            top = cs_p[:, a:b].abs().max()
            assert (cs_k[:, a:b] - cs_p[:, a:b]).abs().max() <= 2e-3 * top
        assert (cu_k - cu_p).abs().max() <= 2e-3 * cu_p.abs().max() > 0
        assert bool((cs_k[:, fr._TSAVG:] == 0).all())
        zs, zu = fr.fused_bwd_call(state, body, stats, ctrl, base,
                                   torch.zeros_like(cot), **kw)
        assert bool((zs == 0).all()) and bool((zu == 0).all())

    body, sim, _, dt = mpc_workload(n=6, device="cuda")
    B, K, S, total = 4, 4, 10, 40
    for env in (EnvParams(gravity_enabled=False, floor_enabled=False), EnvParams()):
        state = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
        stats = fr.make_stats(body, B, dt, sim, env)
        kw = dict(num_steps=S, grid_shape=(6, 6, 6),
                  scalars=fr.kernel_scalars(body.nominal_size, sim, env),
                  flags=dict(fr.kernel_env_flags(sim, env), **fr.body_flags(body),
                             collision=False, segmented=True),
                  n_knots=K, total_steps=total)
        ctrl = _controls(B, K, 216, 7)
        check(state, fr.pack_body(body), stats, ctrl, 0, kw, 1)
        mid, mid_stats = fr.fused_call(state, fr.pack_body(body), stats, None,
                                       control_packed=ctrl, seg_base=0,
                                       **dict(kw, num_steps=20))
        check(mid, fr.pack_body(body), mid_stats, ctrl, 20, kw, 2)

    (state, bodies, stats, _), ekw = evaluator_workload(collision=False, device="cuda")
    state, bodies, stats = (t[:4].contiguous() for t in (state, bodies, stats))
    kw = dict(ekw, num_steps=10, flags=dict(ekw["flags"], segmented=True),
              n_knots=4, total_steps=40)
    ctrl = _controls(4, 4, state.shape[2], 8)
    mid, mid_stats = fr.fused_call(state, bodies, stats, None, control_packed=ctrl,
                                   seg_base=0, **kw)
    check(mid, bodies, mid_stats, ctrl, 10, kw, 3)

    # through the autograd.Function: card against the plain path on the CPU
    grads = []
    for dev in ("cuda", "cpu"):
        b, sm, _, step = mpc_workload(n=6, device=dev)
        dr = DiffRollout(b, sm, EnvParams(), num_steps=24, num_knots=4, dt=step,
                         batch=2, n_segs=3)
        sp = fr.pack_state_single(init_state(b))[None].expand(2, -1, -1).contiguous()
        u = _controls(2, 4, 216, 9).to(dev).requires_grad_(True)
        cms, _, _ = dr(sp, dr.stats0, u)
        grads.append(torch.autograd.grad(cms[-1].sum(), u)[0].cpu())
    assert (grads[0] - grads[1]).abs().max() <= 5e-3 * grads[1].abs().max() > 0
