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
