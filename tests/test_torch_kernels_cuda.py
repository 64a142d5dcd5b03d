"""The port's CUDA kernels against their plain PyTorch versions on the card.

Imports torch only, so it runs on a machine with a card and no JAX:
`python -m pytest -m cuda tests/test_torch_kernels_cuda.py`. Elsewhere it
skips: the kernels have no CPU mode. The plain version's dense pair pass
and its compact pass sum each row here in the kernels' order
(`_kernel_row_sums`), as chip_smoke.py holds K1 to them.
"""

from functools import partial

import pytest
import torch

from evosoro_tpu_torch.ops import fused_rollout as fr


def _kernel_row_sums(terms):
    """sum_j terms[..., j], (n, 3, V, V) -> (n, 3, V), in the order the dense
    pair pass sums a row (csrc/pair_contact.cuh): from zero, ascending j,
    one term at a time; a row's zero terms (pairs that do not touch) are
    skipped, which leaves each sum as it is."""
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


@pytest.fixture(autouse=True)
def _kernel_row_order(monkeypatch):
    monkeypatch.setattr(fr, "pair_contact_forces_plain",
                        partial(fr.pair_contact_forces_plain, row_sum=_kernel_row_sums))
    monkeypatch.setattr(fr, "pair_contact_forces_compact_plain",
                        partial(fr.pair_contact_forces_compact_plain, row_sum=_kernel_row_sums))


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


@pytest.mark.cuda
def test_reverse_mode_segment_over_a_cluster_keeps_one_blocks_bits():
    """B4 with each robot's reverse sweep over a thread-block cluster (8
    robots of 6^3: 6 blocks of one x-plane, `b4_launch_shape`) gives the
    bits the same robots get with one block a robot, as they do inside a
    batch of 136 (the 8 seventeen times over, more clusters than the card
    holds at once), on land from rest and a segment in, and in water with
    the facet drag (8 x 6^3 in its 7^3 shell: 7 blocks). Every batch of
    10^3 robots from 8 to 133 launches in one wave: one block a robot, or
    clusters of which the card holds all at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch.bench import packed_workload

    for n, fluid in ((6, None), (6, "mesh")):
        (state, body, stats, _), kw0, _ = packed_workload(8, n=n, device="cuda", fluid=fluid)
        V = state.shape[2]
        kw = dict(num_steps=10, grid_shape=kw0["grid_shape"], scalars=kw0["scalars"],
                  flags=dict(kw0["flags"], segmented=True), n_knots=4, total_steps=40)
        assert fr.b4_launch_shape(8, kw["grid_shape"], kw["flags"])["cluster"] > 1
        assert fr.b4_launch_shape(136, kw["grid_shape"], kw["flags"])["cluster"] == 1
        ctrl = _controls(8, 4, V, 10)
        g = torch.Generator().manual_seed(11)
        cot = torch.randn(state.shape, generator=g).cuda()
        cot[:, fr._TSAVG:] = 0.0
        mid, mid_stats = fr.fused_call(state, body, stats, None, control_packed=ctrl,
                                       seg_base=0, **kw)
        for st, ss, base in ((state, stats, 0), (mid, mid_stats, 10)):
            many = fr.fused_bwd_call(st, body, ss, ctrl, base, cot, **kw)
            one = fr.fused_bwd_call(st.repeat(17, 1, 1), body, ss.repeat(17, 1),
                                    ctrl.repeat(17, 1, 1), base, cot.repeat(17, 1, 1), **kw)
            assert float(one[1].abs().max()) > 0
            assert torch.equal(many[0], one[0][:8]) and torch.equal(many[1], one[1][:8])
    for B in (8, 16, 17, 24, 25, 32, 33, 48, 66, 67, 133):
        shape = fr.b4_launch_shape(B, (10, 10, 10), kw["flags"])
        assert shape["cluster"] == 1 or shape["clusters_at_once"] >= B, (B, shape)


@pytest.mark.cuda
def test_reverse_mode_segment_in_water_and_with_growth_matches_plain_on_the_card():
    """B4's fluid and development instances against `fused_bwd_plain` on
    the bench design (4^3: in its 5^3 shell in water at 200 x the swimming
    drag, with the facet and the voxel-face drag; with random development
    fields), a segment in under random controls: every channel group within
    2e-3 of the group's largest plain value, zeros for a zero cotangent; and
    `DiffRollout`'s gradient on the card equals the plain path's on the CPU
    (5e-3 of its largest entry)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch.bench import packed_workload, sqp_workload
    from evosoro_tpu_torch.core.rollout import init_state
    from evosoro_tpu_torch.ops.fused_diff import DiffRollout

    groups = dict(pos=(0, 3), quat=(3, 7), linmom=(7, 10), angmom=(10, 13),
                  scale=(13, 14), memory=(17, 44), max_strain=(44, 47))
    B, K, S, total = 4, 4, 10, 40
    for model in ("mesh", "face", "devo"):
        fluid = None if model == "devo" else model
        (state, body, stats, _), kw0, _ = packed_workload(B, n=4, device="cuda", fluid=fluid,
                                                          devo=fluid is None)
        kw = dict(num_steps=S, grid_shape=kw0["grid_shape"], scalars=kw0["scalars"],
                  flags=dict(kw0["flags"], segmented=True), n_knots=K, total_steps=total)
        if fluid:
            stats[:, fr._S_DRAGC] = 1.5e5
        ctrl = _controls(B, K, state.shape[2], 10)
        mid, mid_stats = fr.fused_call(state, body, stats, None, control_packed=ctrl,
                                       seg_base=0, **dict(kw, num_steps=20))
        g = torch.Generator().manual_seed(4)
        cot = torch.randn(mid.shape, generator=g).cuda()
        cot[:, fr._TSAVG:] = 0.0
        before = (fr.FUSED_BWD_LAUNCHES, fr.FUSED_BWD_MESH_LAUNCHES, fr.FUSED_BWD_DEVO_LAUNCHES)
        cs_k, cu_k = fr.fused_bwd_call(mid, body, mid_stats, ctrl, 20, cot, **kw)
        after = (fr.FUSED_BWD_LAUNCHES, fr.FUSED_BWD_MESH_LAUNCHES, fr.FUSED_BWD_DEVO_LAUNCHES)
        assert after == (before[0] + 1, before[1] + (model == "mesh"),
                         before[2] + (model == "devo"))
        cs_p, cu_p = fr.fused_bwd_plain(mid, body, mid_stats, ctrl, 20, cot, **kw)
        for a, b in groups.values():
            top = cs_p[:, a:b].abs().max()
            assert (cs_k[:, a:b] - cs_p[:, a:b]).abs().max() <= 2e-3 * top, (model, a)
        assert (cu_k - cu_p).abs().max() <= 2e-3 * cu_p.abs().max() > 0
        zs, zu = fr.fused_bwd_call(mid, body, mid_stats, ctrl, 20, torch.zeros_like(cot), **kw)
        assert bool((zs == 0).all()) and bool((zu == 0).all())

        grads = []
        for dev in ("cuda", "cpu"):
            b, sm, env, step = sqp_workload(n=4, device=dev, fluid=fluid, devo=fluid is None)
            dr = DiffRollout(b, sm, env, num_steps=24, num_knots=4, dt=step, batch=2,
                             n_segs=3)
            sp = fr.pack_state_single(init_state(b))[None].expand(2, -1, -1).contiguous()
            u = _controls(2, 4, b.occ.numel(), 9).to(dev).requires_grad_(True)
            cms, _, _ = dr(sp, dr.stats0, u)
            grads.append(torch.autograd.grad(cms[-1].sum(), u)[0].cpu())
        assert (grads[0] - grads[1]).abs().max() <= 5e-3 * grads[1].abs().max() > 0, model


@pytest.mark.cuda
def test_reverse_mode_segment_on_materials_matches_plain_on_the_card():
    """B4's material instance (bilinear stress, the max-velocity clamp)
    against `fused_bwd_plain` on `sqp_workload(n=4, materials=True)`, a
    segment in under random controls: every channel group within 2e-3 of
    the group's largest plain value, its counter counted; the device-memory
    twin, forced, bit-equal; and `DiffRollout`'s gradient through three
    segments equal to autograd through 24 steps of the plain version on the
    card (2e-3 of its largest entry: on the card K1 computes the plain
    version's bits, so both differentiate the same trajectory, its yield and
    clamp decisions included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from unittest import mock

    from evosoro_tpu_torch.bench import sqp_workload
    from evosoro_tpu_torch.core.rollout import init_state
    from evosoro_tpu_torch.ops.fused_diff import DiffRollout

    groups = dict(pos=(0, 3), quat=(3, 7), linmom=(7, 10), angmom=(10, 13),
                  scale=(13, 14), memory=(17, 44), max_strain=(44, 47))
    B, K, S, total = 4, 4, 10, 40
    body, sim, env, dt = sqp_workload(n=4, device="cuda", materials=True)
    kw = dict(num_steps=S, grid_shape=tuple(body.occ.shape),
              scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=fr.launch_flags(body, sim, env, collision=False, segmented=True),
              n_knots=K, total_steps=total)
    bp = fr.pack_body(body)
    state = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
    stats = fr.make_stats(body, B, dt, sim, env)
    ctrl = _controls(B, K, state.shape[2], 10)
    mid, mid_stats = fr.fused_call(state, bp, stats, None, control_packed=ctrl, seg_base=0,
                                   **dict(kw, num_steps=20))
    g = torch.Generator().manual_seed(4)
    cot = torch.randn(mid.shape, generator=g).cuda()
    cot[:, fr._TSAVG:] = 0.0
    before = fr.FUSED_BWD_MATERIAL_LAUNCHES
    cs_k, cu_k = fr.fused_bwd_call(mid, bp, mid_stats, ctrl, 20, cot, **kw)
    assert fr.FUSED_BWD_MATERIAL_LAUNCHES == before + 1
    cs_p, cu_p = fr.fused_bwd_plain(mid, bp, mid_stats, ctrl, 20, cot, **kw)
    for a, b in groups.values():
        top = cs_p[:, a:b].abs().max()
        assert (cs_k[:, a:b] - cs_p[:, a:b]).abs().max() <= 2e-3 * top, a
    assert (cu_k - cu_p).abs().max() <= 2e-3 * cu_p.abs().max() > 0
    with mock.patch.object(fr, "k1_instance", lambda *a, **k: "device"):
        twin = fr.fused_bwd_call(mid, bp, mid_stats, ctrl, 20, cot, **kw)
    assert torch.equal(twin[0], cs_k) and torch.equal(twin[1], cu_k)

    dr = DiffRollout(body, sim, env, num_steps=24, num_knots=4, dt=dt, batch=2, n_segs=3)
    sp = fr.pack_state_single(init_state(body))[None].expand(2, -1, -1).contiguous()
    u = _controls(2, 4, body.occ.numel(), 9).requires_grad_(True)
    cms, _, _ = dr(sp, dr.stats0, u)
    (g_k,) = torch.autograd.grad(cms[-1].sum(), u)
    u_p = u.detach().clone().requires_grad_(True)
    out, out_stats = fr.fused_rollout_plain(sp, dr.body_packed, dr.stats0, None,
                                            control_packed=u_p, seg_base=0,
                                            **dict(dr._kw, num_steps=24))
    (g_p,) = torch.autograd.grad(dr.cm_y(out, out_stats).sum(), u_p)
    assert (g_k - g_p).abs().max() <= 2e-3 * g_p.abs().max() > 0


def _groups_within(out_k, out_p, tol):
    """Every named channel group of the packed state within its (rtol, atol)."""
    for name, (a, b) in dict(pos=(fr._POS, fr._POS + 3), quat=(fr._QUAT, fr._QUAT + 4),
                             linmom=(fr._LIN, fr._LIN + 3),
                             scale=(fr._SCALE, fr._SCALE + 1)).items():
        rtol, atol = tol[name]
        torch.testing.assert_close(out_k[:, a:b], out_p[:, a:b], rtol=rtol, atol=atol,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
def test_fluid_variants_match_plain_on_the_card():
    """K1's voxel-face and facet-drag variants against the plain version
    (the eager step with `_fluid_drag`, or `mesh_drag_forces` over gather
    tables) on the bench design in its shell and on the swimming
    experiment's own batch, contact off and on, at the experiment's drag
    coefficient and at 200 times it, where drag weighs as much as
    elasticity. The face model shares the land step's tolerances; the facet
    drag sums its terms in another order than the gather tables do and is
    held at the JAX package's own tolerances between its kernel and its jnp
    step (tests/test_fused_rollout.py:766-774) for pos and scale, at the land
    step's for quat, and at rtol 1e-4, atol 5e-5 for linmom (the two part by
    9.3e-6 at the high coefficient on an H100). A launch without drag and
    the other model on the same grid must fail them at the high coefficient.
    Two block sizes are covered: 512 threads (1331 and 343 cells; K1's
    `k1_threads`) and, with a 3^3 design in its 4^3 shell, 192."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch.bench import evaluator_workload, packed_workload

    face_tol = dict(pos=(2e-5, 1e-9), quat=(2e-5, 1e-7), linmom=(1e-4, 1e-10),
                    scale=(1e-6, 0.0))
    mesh_tol = dict(pos=(2e-5, 1e-8), quat=(2e-5, 1e-7), linmom=(1e-4, 5e-5),
                    scale=(1e-6, 0.0))
    for model, tol in (("face", face_tol), ("mesh", mesh_tol)):
        for coll in (False, True):
            workloads = [
                packed_workload(8, n=10, collision=coll, device="cuda", fluid=model)[:2],
                packed_workload(8, n=3, collision=coll, device="cuda", fluid=model)[:2],
                evaluator_workload(collision=coll, stagger=True, device="cuda",
                                   experiment="swimming",
                                   drag_model="mesh" if model == "mesh" else "voxel_face")]
            for args, kw in workloads:
                for coefficient in (750.0, 1.5e5):
                    stats = args[2].clone()
                    stats[:, fr._S_DRAGC] = coefficient
                    cargs = (args[0], args[1], stats, args[3])
                    before = fr.FUSED_ROLLOUT_FLUID_LAUNCHES
                    out_k, st_k = fr.fused_call(*cargs, num_steps=100, **kw)
                    assert fr.FUSED_ROLLOUT_FLUID_LAUNCHES == before + 1
                    out_p, st_p = fr.fused_rollout_plain(*cargs, num_steps=100, **kw)
                    _groups_within(out_k, out_p, tol)
                    torch.testing.assert_close(st_k, st_p, rtol=1e-5, atol=1e-7)
                calm = stats.clone()
                calm[:, fr._S_DRAGC] = 0.0
                out_0, _ = fr.fused_call(args[0], args[1], calm, args[3],
                                         num_steps=100, **kw)
                with pytest.raises(AssertionError):
                    _groups_within(out_0, out_p, tol)
                X, Y, Z = kw["grid_shape"]
                if fr.has_corner_shell(args[1][:, fr._B_OCC].reshape(-1, X, Y, Z) > 0.5):
                    other = dict(kw, flags=dict(kw["flags"], fluid_mesh=model != "mesh"))
                    out_o, _ = fr.fused_call(*cargs, num_steps=100, **other)
                    with pytest.raises(AssertionError):
                        _groups_within(out_o, out_p, tol)


@pytest.mark.cuda
def test_development_variant_matches_plain_on_the_card():
    """K1's development variant against the plain version, at the land
    step's tolerances: random growth fields on the bench design (without and
    with the mid-life freeze) and the growth experiment's own batch, contact
    off and on; the land variant on the same tensors must differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch.bench import evaluator_workload, packed_workload

    workloads = [packed_workload(8, n=6, device="cuda", devo=True, freeze=f)[:2]
                 for f in (False, True)]
    workloads += [evaluator_workload(collision=coll, stagger=True, device="cuda",
                                     experiment="growth") for coll in (False, True)]
    for args, kw in workloads:
        for steps in (25, 100):
            before = fr.FUSED_ROLLOUT_DEVO_LAUNCHES
            out_k, st_k = fr.fused_call(*args, num_steps=steps, **kw)
            assert fr.FUSED_ROLLOUT_DEVO_LAUNCHES == before + 1
            out_p, st_p = fr.fused_rollout_plain(*args, num_steps=steps, **kw)
            torch.testing.assert_close(out_k, out_p, rtol=2e-5, atol=1e-7)
            torch.testing.assert_close(st_k, st_p, rtol=1e-5, atol=1e-7)
        land = dict(kw, flags=dict(kw["flags"], **{k: False for k in fr._K1_DEVO_FLAGS}))
        out_l, _ = fr.fused_call(*args, num_steps=100, **land)
        assert float((out_l[:, fr._SCALE] - out_p[:, fr._SCALE]).abs().max()) > 1e-4


@pytest.mark.cuda
def test_feature_instance_matches_plain_on_the_card():
    """K1's fitness features against the plain version (the workloads and
    tolerances of chip_smoke.py's phase_k1_features, at 60 steps): the
    state at the land step's tolerances, counters, latches and minima
    equal, the sums over voxels at rtol 1e-5 / atol 1e-6 lattice units;
    ballistic development's channels on the growth batch with contact on,
    as the ballistic experiment runs it, at rtol 1e-6, and some robot
    rebased."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch.bench import ballistic_workload, feature_workload

    exact = (fr._S_NTR, fr._S_LASTTR, fr._S_WCNT, fr._S_LASTWIN, fr._S_FELL, fr._S_NCAP,
             fr._S_EOLCAP, fr._S_EOLY, fr._S_SRC + 6)
    for n_win, n_src in ((4, 3), (12, 1)):
        args, kw = feature_workload(n_win=n_win, n_src=n_src, device="cuda")
        before = fr.FUSED_ROLLOUT_FEATURE_LAUNCHES
        out_k, st_k = fr.fused_call(*args, num_steps=60, **kw)
        assert fr.FUSED_ROLLOUT_FEATURE_LAUNCHES == before + 1
        out_p, st_p = fr.fused_rollout_plain(*args, num_steps=60, **kw)
        torch.testing.assert_close(out_k[:, :fr._TSAVG], out_p[:, :fr._TSAVG],
                                   rtol=2e-5, atol=1e-7)
        for ch in exact:
            assert torch.equal(st_k[:, ch], st_p[:, ch]), ch
        torch.testing.assert_close(st_k[:, fr._S_SRC:fr._S_EOLCAP + 1],
                                   st_p[:, fr._S_SRC:fr._S_EOLCAP + 1], rtol=1e-5, atol=1e-6)
    args, kw = ballistic_workload(device="cuda")
    out_k, st_k = fr.fused_call(*args, num_steps=200, **kw)
    out_p, st_p = fr.fused_rollout_plain(*args, num_steps=200, **kw)
    dd = slice(fr._DEVO_DYN, fr._DEVO_DYN + 4)
    torch.testing.assert_close(out_k[:, dd], out_p[:, dd], rtol=1e-6, atol=0.0)
    assert float((out_p[:, dd] - args[0][:, dd]).abs().max()) > 0
    assert torch.equal(st_k[:, fr._S_WCNT], st_p[:, fr._S_WCNT])


@pytest.mark.cuda
def test_material_instance_matches_plain_on_the_card(tmp_path):
    """K1's material instance against its plain version at the JAX package's
    tolerances for these branches (tests/test_fused_rollout.py:381-682):
    the materials experiment's batch (bilinear muscle, MDL_DATA tissue,
    plasticity, the max-velocity clamp, contact on), 100 steps; equilibrium
    mode on a moving 6^3 bench design, 60 steps (the zeroing fires);
    the hand-written cantilever, whose pinned face stays put bit for bit;
    the compact contact pass from a lattice shrunk into contact, one step,
    by K2's rule. A guard each: the branch's bit cleared fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch import bench

    pos, lin = slice(fr._POS, fr._POS + 3), slice(fr._LIN, fr._LIN + 3)
    soff, ke = slice(fr._SOFF, fr._SOFF + 3), slice(fr._S_KE, fr._S_KE + 6)

    def close(a, b, rtol, atol):
        return bool(((a - b).abs() <= atol + rtol * b.abs()).all())

    def run(args, kw, steps, **flags):
        gkw = dict(kw, flags=dict(kw["flags"], **flags))
        if flags.get("mdl_data") is False:
            gkw["ss_packed"] = None
        if flags.get("bc") is False:
            gkw["bc_packed"] = None
        if flags.get("collision") is False:
            args = args[:3] + (None,)
        return fr.fused_call(*args, num_steps=steps, **gkw)

    def plain(args, kw, steps):
        before = fr.FUSED_ROLLOUT_MATERIAL_LAUNCHES
        out_k, st_k = fr.fused_call(*args, num_steps=steps, **kw)
        torch.cuda.synchronize()
        assert fr.FUSED_ROLLOUT_MATERIAL_LAUNCHES == before + 1
        return out_k, st_k, *fr.fused_rollout_plain(*args, num_steps=steps, **kw)

    args, kw = bench.materials_workload(device="cuda")
    out_k, _, out_p, _ = plain(args, kw, 100)
    assert close(out_k[:, pos], out_p[:, pos], 5e-5, 1e-8)
    assert close(out_k[:, soff], out_p[:, soff], 1e-4, 1e-7)
    assert float(out_p[:, soff].abs().max()) > 0
    for flags in (dict(nonlinear=False, mdl_data=False), dict(max_vel=False)):
        assert not close(run(args, kw, 100, **flags)[0][:, pos], out_p[:, pos], 5e-5, 1e-8)
    assert not close(run(args, kw, 100, plasticity=False)[0][:, soff], out_p[:, soff],
                     1e-4, 1e-7)

    # a moving body free of floor and gravity: its energy falls and the
    # mode zeroes it within the launch
    args, kw, _ = bench.packed_workload(2, n=6, device="cuda", equilibrium=True)
    state = args[0].clone()
    g = torch.Generator().manual_seed(2)
    occ = args[1][0, fr._B_OCC] > 0.5
    state[:, lin] = torch.where(occ, 1e-3 * torch.randn((2, 3, 216), generator=g).cuda(), 0.0)
    args = (state,) + args[1:]
    kw = dict(kw, flags=dict(kw["flags"], gravity=False, floor=False, temp=False,
                             temp_enabled=False))
    out_k, st_k, out_p, st_p = plain(args, kw, 60)
    assert close(out_k[:, pos], out_p[:, pos], 2e-5, 1e-8)
    assert close(out_k[:, lin], out_p[:, lin], 1e-3, 1e-10)
    assert close(st_k[:, ke], st_p[:, ke], 1e-3, 0.0)
    off = dict(kw, scalars=fr.equilibrium_scalars(kw["scalars"]))
    assert not close(run(args, off, 60, equilibrium=False)[0][:, lin], out_p[:, lin],
                     1e-3, 1e-10)

    args, kw, body = bench.cantilever_workload(str(tmp_path / "cantilever.vxa"), batch=2,
                                               device="cuda")
    out_k, _, out_p, _ = plain(args, kw, 100)
    assert close(out_k[:, pos], out_p[:, pos], 2e-5, 1e-9)
    assert close(out_k[:, lin], out_p[:, lin], 1e-3, 1e-10)
    pinned = ((body.dof_fixed == 63) & body.occ).flatten()
    nom = (body.nom_pos + body.external_disp).reshape(-1, 3).T
    assert torch.equal(out_k[:, pos][:, :, pinned], nom[:, pinned].expand(2, -1, -1))
    assert not close(run(args, kw, 100, bc=False)[0][:, pos], out_p[:, pos], 2e-5, 1e-9)

    args, kw, _ = bench.packed_workload(4, collision=True, compact=True, device="cuda")
    state = args[0].clone()
    nom = state[:, pos]
    centre = nom.mean(-1, keepdim=True)
    g = torch.Generator().manual_seed(0)
    state[:, pos] = centre + 0.5 * (nom - centre) + 5e-4 * torch.randn(
        nom.shape, generator=g).cuda()
    args = (state,) + args[1:]
    before = fr.FUSED_ROLLOUT_COMPACT_LAUNCHES
    out_k, _, out_p, _ = plain(args, kw, 1)
    assert fr.FUSED_ROLLOUT_COMPACT_LAUNCHES == before + 1
    top = float(out_p[:, lin].abs().max())
    assert float((out_k[:, lin] - out_p[:, lin]).abs().max()) <= 1e-4 * top
    no_contact = run(args, kw, 1, collision=False, collision_compact=False)[0]
    assert float((no_contact[:, lin] - out_p[:, lin]).abs().max()) > 1e-2 * top


@pytest.mark.cuda
def test_volume_instance_matches_plain_on_the_card(tmp_path):
    """K1's volume instance against its plain version at the tolerances of
    tests/test_fused_rollout.py:284-327 (pos rtol 2e-4 atol 2e-8, the
    coupling carry's side means, the stats row's dt and time): the JAX
    package's volume parity design 8 x 4^3, the volume experiment's batch
    (contact on) and the cantilever with volume effects, 25 steps each. The
    guard, on the two actuated launches: the volume bit cleared leaves the
    transverse sums at their start and fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch import bench

    pos, ts, cs = slice(fr._POS, fr._POS + 3), slice(fr._TSAVG, fr._TSAVG + 3), \
        slice(fr._CSAVG, fr._CSAVG + 3)

    def close(a, b, rtol, atol):
        return bool(((a - b).abs() <= atol + rtol * b.abs()).all())

    cant = bench.cantilever_workload(str(tmp_path / "cantilever.vxa"), batch=2,
                                     device="cuda", volume=True)[:2]
    for case, (args, kw) in enumerate((bench.volume_scenario_workload(8, device="cuda"),
                                       bench.volume_workload(device="cuda"), cant)):
        before = fr.FUSED_ROLLOUT_VOLUME_LAUNCHES
        out_k, st_k = fr.fused_call(*args, num_steps=25, **kw)
        torch.cuda.synchronize()
        assert fr.FUSED_ROLLOUT_VOLUME_LAUNCHES == before + 1
        out_p, st_p = fr.fused_rollout_plain(*args, num_steps=25, **kw)
        assert close(out_k[:, pos], out_p[:, pos], 2e-4, 2e-8)
        assert close(out_k[:, ts], out_p[:, ts], 2e-3, 1e-6)
        assert close(out_k[:, cs], out_p[:, cs], 1e-4, 0.0)
        for k in (fr._S_DT, fr._S_TIME):
            assert close(st_k[:, k], st_p[:, k], 1e-6, 0.0)
        assert float(out_p[:, ts].abs().max()) > 0
        if case < 2:
            off, _ = fr.fused_call(*args, num_steps=25,
                                   **dict(kw, flags=dict(kw["flags"], volume=False)))
            assert not close(off[:, ts], out_p[:, ts], 2e-3, 1e-6)


@pytest.mark.cuda
def test_device_memory_instances_match_on_the_card():
    """K1's and B4's device-memory instances: bit-equal to the shared-memory
    instances on bodies both run (the evaluator batch with contact, the SQP
    solve's K1 segment with knots and its B4 launch), the one past the shared ceiling (1340 cells with contact)
    launched and held against the plain version, and a 12^3 batch with
    contact at K1's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch.bench import big_body_workload, evaluator_workload, mpc_workload
    from evosoro_tpu_torch.core.rollout import init_state
    from evosoro_tpu_torch.core.types import EnvParams

    from unittest import mock

    def forced():
        return mock.patch.object(fr, "k1_instance", lambda *a, **k: "device")

    args, kw = evaluator_workload(collision=True, stagger=True, device="cuda")
    g0 = fr.FUSED_ROLLOUT_GMEM_LAUNCHES
    shared = fr.fused_call(*args, num_steps=100, **kw)
    assert fr.FUSED_ROLLOUT_GMEM_LAUNCHES == g0
    with forced():
        device = fr.fused_call(*args, num_steps=100, **kw)
    assert fr.FUSED_ROLLOUT_GMEM_LAUNCHES == g0 + 1
    assert all(torch.equal(a, b) for a, b in zip(shared, device))

    assert fr.k1_instance(1340, True) == "device"
    args, kw, _ = big_body_workload(2, n=12, device="cuda")
    for steps in (1, 25):
        out_k, st_k = fr.fused_call(*args, num_steps=steps, **kw)
        out_p, st_p = fr.fused_rollout_plain(*args, num_steps=steps, **kw)
        torch.testing.assert_close(out_k[:, :fr._TSAVG], out_p[:, :fr._TSAVG],
                                   rtol=2e-5, atol=1e-7)
        torch.testing.assert_close(st_k, st_p, rtol=1e-5, atol=1e-7)
    assert fr.FUSED_ROLLOUT_GMEM_LAUNCHES == g0 + 3

    body, sim, _, dt = mpc_workload(device="cuda")
    env = EnvParams(gravity_enabled=False, floor_enabled=False)
    B, K = 4, 8
    state = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
    stats = fr.make_stats(body, B, dt, sim, env)
    ctrl = _controls(B, K, body.occ.numel(), 5)
    cot = torch.randn(state.shape, generator=torch.Generator().manual_seed(1)).cuda()
    kw = dict(num_steps=25, grid_shape=tuple(body.occ.shape),
              scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=dict(fr.kernel_env_flags(sim, env), **fr.body_flags(body),
                         collision=False, segmented=True), n_knots=K, total_steps=200)
    # K1 with knots in segmented mode, mid-clock, as the SQP solve launches it
    g1 = fr.FUSED_ROLLOUT_GMEM_LAUNCHES
    seg = dict(control_packed=ctrl, seg_base=75, **kw)
    a = fr.fused_call(state, fr.pack_body(body), stats, None, **seg)
    with forced():
        b = fr.fused_call(state, fr.pack_body(body), stats, None, **seg)
    assert fr.FUSED_ROLLOUT_GMEM_LAUNCHES == g1 + 1
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    b0 = fr.FUSED_BWD_GMEM_LAUNCHES
    a = fr.fused_bwd_call(state, fr.pack_body(body), stats, ctrl, 0, cot, **kw)
    with forced():
        b = fr.fused_bwd_call(state, fr.pack_body(body), stats, ctrl, 0, cot, **kw)
    assert fr.FUSED_BWD_GMEM_LAUNCHES == b0 + 1
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_compact_pass_equals_the_dense_pass_on_the_card():
    """The surface-compacted contact pass (B5) on the bench design, 4 x 10^3
    on `materials_palette`, its lattice shrunk into contact: K1 with the
    compact table and with the dense one, both in the material instance,
    give the same state and stats over 1 and 25 steps; the pass's own
    launch equals its plain version and the dense plain pass bit for bit,
    each summing a row in the kernels' order, and counts the census's tiles
    over the index row; a cull margin of -0.5 drops the touching tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from unittest import mock

    from evosoro_tpu_torch.bench import packed_workload

    (state, body, stats, compact), kw_c, _ = packed_workload(
        4, collision=True, compact=True, materials=True, device="cuda")
    dense, kw_d = packed_workload(4, collision=True, materials=True, device="cuda")[:2]
    dense = dense[3]
    pos = state[:, fr._POS:fr._POS + 3]
    g = torch.Generator().manual_seed(0)
    state = state.clone()
    centre = pos.mean(-1, keepdim=True)
    state[:, fr._POS:fr._POS + 3] = centre + 0.5 * (pos - centre) + 5e-4 * torch.randn(
        pos.shape, generator=g).cuda()
    before = fr.FUSED_ROLLOUT_COMPACT_LAUNCHES
    for steps in (1, 25):
        out_c = fr.fused_call(state, body, stats, compact, num_steps=steps, **kw_c)
        out_d = fr.fused_call(state, body, stats, dense, num_steps=steps, **kw_d)
        assert all(torch.equal(a, b) for a, b in zip(out_c, out_d))
    assert fr.FUSED_ROLLOUT_COMPACT_LAUNCHES == before + 2
    pos = state[:, fr._POS:fr._POS + 3].contiguous()
    scale = state[:, fr._SCALE].contiguous()
    counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    f_k = fr.pair_contact_forces_compact(pos, scale, compact, counts=counts)
    f_p = fr.pair_contact_forces_compact_plain(pos, scale, compact)
    assert float(f_p.abs().max()) > 0
    assert torch.equal(f_k, f_p) and torch.equal(f_k, fr.pair_contact_forces_plain(pos, scale,
                                                                                  dense))
    assert tuple(counts.tolist()) == fr.pair_tile_census_plain(
        pos.cpu(), scale.cpu(), compact[:, 1:].cpu(), idx=compact[:, 0].cpu())
    with mock.patch.object(fr, "PAIR_CULL_MARGIN", -0.5):
        dropped = fr.pair_contact_forces_compact(pos, scale, compact)
    assert float((dropped - f_p).abs().max()) > 2e-3 * float(f_p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["face", "mesh", "devo"])
def test_material_instances_in_water_and_with_growth_match_plain_on_the_card(model):
    """K1's material and volume instances of each variant (the bench design
    4 x 5^3 on `materials_palette` with plasticity and the clamp, 25 steps)
    against the plain version at the material instance's gates, with the
    dense pass on the lattice squeezed into contact and without, and the
    compact launch bit-equal to the dense one; B4's material instance of
    the variant (`sqp_workload(n=4, materials=True)`, a segment in under
    random controls) within 2e-3 of autograd a channel group."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    from evosoro_tpu_torch.bench import MATERIALS_MAX_VEL, packed_workload, sqp_workload
    from evosoro_tpu_torch.core.rollout import init_state

    opts = dict(fluid=model) if model != "devo" else dict(devo=True)
    for vol in (False, True):
        runs = {}
        for contact in (None, "dense", "compact"):
            args, kw, _ = packed_workload(4, n=4, collision=contact is not None,
                                          compact=contact == "compact", device="cuda",
                                          materials=True, volume=vol, **opts)
            kw = dict(kw, scalars=dict(kw["scalars"], max_vel_limit=MATERIALS_MAX_VEL))
            state = args[0].clone()
            if contact:
                occ = args[1][0, fr._B_OCC] > 0.5
                p = state[:, fr._POS:fr._POS + 3]
                c = p[:, :, occ].mean(2, keepdim=True)
                state[:, fr._POS:fr._POS + 3] = torch.where(occ, c + 0.6 * (p - c), p)
            args = (state,) + args[1:]
            out_k, st_k = fr.fused_call(*args, num_steps=25, **kw)
            out_p, st_p = fr.fused_rollout_plain(*args, num_steps=25, **kw)
            runs[contact] = (out_k, st_k)
            torch.testing.assert_close(out_k[:, :3], out_p[:, :3], rtol=2e-4, atol=5e-8)
            torch.testing.assert_close(st_k[:, fr._S_TIME], st_p[:, fr._S_TIME], rtol=1e-6,
                                       atol=0.0)
        assert torch.equal(runs["compact"][0], runs["dense"][0])
        assert torch.equal(runs["compact"][1], runs["dense"][1])

    groups = dict(pos=(0, 3), quat=(3, 7), linmom=(7, 10), angmom=(10, 13),
                  scale=(13, 14), memory=(17, 44), max_strain=(44, 47))
    B, K, S, total = 4, 4, 10, 40
    body, sim, env, dt = sqp_workload(n=4, device="cuda", materials=True, **opts)
    kw = dict(num_steps=S, grid_shape=tuple(body.occ.shape),
              scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=fr.launch_flags(body, sim, env, collision=False, segmented=True),
              n_knots=K, total_steps=total)
    bp = fr.pack_body(body)
    state = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
    stats = fr.make_stats(body, B, dt, sim, env)
    ctrl = _controls(B, K, state.shape[2], 12)
    mid, mid_stats = fr.fused_call(state, bp, stats, None, control_packed=ctrl, seg_base=0,
                                   **dict(kw, num_steps=20))
    g = torch.Generator().manual_seed(5)
    cot = torch.randn(mid.shape, generator=g).cuda()
    cot[:, fr._TSAVG:] = 0.0
    before = fr.FUSED_BWD_MATERIAL_LAUNCHES
    cs_k, cu_k = fr.fused_bwd_call(mid, bp, mid_stats, ctrl, 20, cot, **kw)
    assert fr.FUSED_BWD_MATERIAL_LAUNCHES == before + 1
    cs_p, cu_p = fr.fused_bwd_plain(mid, bp, mid_stats, ctrl, 20, cot, **kw)
    for a, b in groups.values():
        top = cs_p[:, a:b].abs().max()
        assert (cs_k[:, a:b] - cs_p[:, a:b]).abs().max() <= 2e-3 * top, a
    assert (cu_k - cu_p).abs().max() <= 2e-3 * cu_p.abs().max() > 0
