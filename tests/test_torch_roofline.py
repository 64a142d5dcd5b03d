"""The port's roofline accounting (`evosoro_tpu_torch.roofline`) on the CPU:
the plain version of the FP32 micro-kernel, the wrapper's rules, and the
counts of work behind each kernel's bound. The kernel itself and the peak
are measured on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from evosoro_tpu_torch import roofline
from evosoro_tpu_torch.ops import build
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)


def test_fma_chains_plain_is_the_sum_of_the_sixteen_chains():
    """Against the closed form of acc -> a acc + b in float64: after n steps
    a^n acc0 + b (a^n - 1)/(a - 1). The plain version rounds to float32 at
    every step as the kernel does, half a float32 ulp each, so rtol is
    n * 2^-24 (3.8e-6 at 64 steps) plus 1e-6 for the float32 start values
    and the float32 sum. The 64 steps move a chain by 7.6e-6."""
    x = torch.tensor([0.5, 1.0, 1.5])
    n = 64
    a, b = roofline.FMA_A, roofline.FMA_B
    want = sum(a ** n * (x.double() * float(np.float32(1) + np.float32(1e-7) * np.float32(k)))
               + b * (a ** n - 1) / (a - 1) for k in range(roofline.CHAINS))
    got = roofline.fma_chains(x, n)  # a CPU tensor takes the plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=n * 2.0 ** -24 + 1e-6)
    assert roofline.FMA_PEAK_LAUNCHES == 0


def _round_to_float32(q: Fraction) -> np.float32:
    """The float32 nearest to the exact rational q (ties to even)."""
    lo = np.float32(float(q))
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))]
    err = [abs(Fraction(float(c)) - q) for c in cands]
    best = min(err)
    tied = [c for c, e in zip(cands, err) if e == best]
    if len(tied) == 1:
        return tied[0]
    return next(c for c in tied if int(c.view(np.uint32)) % 2 == 0)


def test_fma_chains_plain_rounds_once_a_step_like_a_fused_multiply_add():
    """Every chain of the plain version against exact rational arithmetic
    rounded once to float32 at each step, which is what a fused multiply-add
    computes: the sums are equal bit for bit over 200 steps, where 200
    steps move a chain by 2.4e-5 (hundreds of float32 ulps), and differ
    from the 196-step sums (one step moves a sum by about one of its ulps,
    four steps by several)."""
    xs = np.random.default_rng(0).uniform(0.5, 1.5, size=6).astype(np.float32)
    a, b = Fraction(roofline.FMA_A), Fraction(roofline.FMA_B)
    n = 200
    want = []
    for x0 in xs:
        accs = [np.float32(x0) * (np.float32(1) + np.float32(1e-7) * np.float32(k))
                for k in range(roofline.CHAINS)]
        for _ in range(n):
            accs = [_round_to_float32(Fraction(float(acc)) * a + b) for acc in accs]
        total = accs[0]
        for acc in accs[1:]:
            total = np.float32(total + acc)
        want.append(total)
    got = roofline.fma_chains_plain(torch.as_tensor(xs), n).numpy()
    np.testing.assert_array_equal(got, np.asarray(want, dtype=np.float32))
    fewer = roofline.fma_chains_plain(torch.as_tensor(xs), n - 4).numpy()
    assert (fewer != got).all()


def test_fma_wrapper_rules():
    with pytest.raises(TypeError):
        roofline.fma_chains(torch.ones(4, dtype=torch.float64), 4)
    with pytest.raises(TypeError):
        roofline.fma_chains(torch.ones(2, 2), 4)
    with pytest.raises(ValueError, match="card"):
        roofline.measure_fp32_peak(device="cpu")
    name, argtypes = build.SIGNATURES["fma_peak"]
    assert name == "fma_peak" and len(argtypes) == 7
    assert (build.CSRC / "fma_peak.cu").exists()


def test_bound_takes_the_larger_side():
    by_ops = roofline.bound(67e12, 1.0)
    assert by_ops["bound_by"] == "operations"
    np.testing.assert_allclose(by_ops["bound_ms"], 1e3)
    by_bytes = roofline.bound(1.0, 3.35e12)
    assert by_bytes["bound_by"] == "bytes"
    np.testing.assert_allclose(by_bytes["bound_ms"], 1e3)
    slower = roofline.bound(67e12, 1.0, fp32_flops=33.5e12)
    np.testing.assert_allclose(slower["bound_ms"], 2e3)
    assert roofline.fma_work(10, 3) == (2.0 * 16 * 3 * 10, 80.0)


def test_k1_work_counts_the_steps_each_robot_ran():
    B, V = 3, 8
    state = torch.zeros(B, fr.C_S, V)
    body = torch.zeros(1, fr.C_B, V)
    body[0, fr._B_OCC, :6] = 1.0  # six of the grid's eight cells hold a voxel
    stats = torch.zeros(B, fr.C_STAT)
    stats[:, fr._S_DT] = 0.5
    out = stats.clone()
    out[:, fr._S_TIME] = torch.tensor([5.0, 5.0, 2.0])  # the third froze early
    flops, nbytes = roofline.k1_work(state, body, stats, None, out)
    np.testing.assert_allclose(flops, 24 * 6 * roofline.STEP_FLOPS_PER_VOXEL)
    base = 4.0 * (2 * B * 47 * V + 69 * V + 2 * B * fr.C_STAT)
    assert nbytes == base
    table = torch.zeros(1, V, V)
    table[0, 0, 1] = table[0, 1, 0] = 1.0
    ctrl = torch.zeros(B, 2, V)
    flops2, nbytes2 = roofline.k1_work(state, body, stats, table, out, ctrl)
    np.testing.assert_allclose(flops2 - flops, 24 * 2 * roofline.PAIR_FLOPS_TESTED)
    assert nbytes2 == base + 4.0 * (V * V + B * 2 * V)
    # a body per robot: each robot's steps count its own occupied voxels
    bodies = torch.zeros(B, fr.C_B, V)
    for b, n_occ in enumerate((8, 4, 2)):
        bodies[b, fr._B_OCC, :n_occ] = 1.0
    flops3, _ = roofline.k1_work(state, bodies, stats, None, out)
    np.testing.assert_allclose(
        flops3, (10 * 8 + 10 * 4 + 4 * 2) * roofline.STEP_FLOPS_PER_VOXEL)


def test_k2_work_counts_tested_and_touching_pairs():
    pos = torch.tensor([[[0.0, 0.01, 1.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]])
    scale = torch.full((1, 3), 0.01)
    a1 = torch.ones(1, 3, 3) - torch.eye(3)
    flops, nbytes = roofline.k2_work(pos, scale, a1)
    # six tested ordered pairs; voxels 0 and 1 touch (0.01 apart, reach 0.015)
    assert flops == 6 * roofline.PAIR_FLOPS_TESTED + 2 * roofline.PAIR_FLOPS_TOUCHING
    assert nbytes == 4.0 * (9 + 3 + 9 + 9)
    f = fr.pair_contact_forces(pos, scale, a1)
    assert int((f.abs().sum(1) > 0).sum()) == 2


def test_b4_work_counts_recompute_and_adjoint_of_the_steps_taken():
    B, V, K = 3, 8, 2
    state = torch.zeros(B, fr.C_S, V)
    body = torch.zeros(1, fr.C_B, V)
    body[0, fr._B_OCC, :6] = 1.0
    stats = torch.zeros(B, fr.C_STAT)
    ctrl = torch.zeros(B, K, V)
    flops, nbytes = roofline.b4_work(state, body, stats, ctrl, [5, 5, 2])  # the third froze
    per = roofline.STEP_FLOPS_PER_VOXEL + roofline.ADJOINT_FLOPS_PER_VOXEL
    np.testing.assert_allclose(flops, 12 * 6 * per)
    # start state and end cotangent in, start cotangent out; body; stats;
    # controls in and their cotangent out; never the tape
    assert nbytes == 4.0 * (3 * B * 47 * V + 69 * V + B * fr.C_STAT + 2 * B * K * V)
    bodies = torch.zeros(B, fr.C_B, V)
    for b, n_occ in enumerate((8, 4, 2)):
        bodies[b, fr._B_OCC, :n_occ] = 1.0
    flops2, _ = roofline.b4_work(state, bodies, stats, ctrl, torch.tensor([5, 5, 2]))
    np.testing.assert_allclose(flops2, (5 * 8 + 5 * 4 + 2 * 2) * per)
    assert roofline.bound(flops, nbytes)["bound_by"] == "operations"


def test_adjoint_operation_count_is_the_jaxpr_walk_of_the_steps_vjp():
    """`ADJOINT_FLOPS_PER_VOXEL` is a count, and this is where it comes
    from: `tools/roofline.py`'s jaxpr walk over `jax.vjp` of the JAX
    package's `sim_step` with the control offset on the 10^3 bench body
    (forward pass and pullback), less the same walk over the forward step."""
    import jax
    import jax.numpy as jnp

    from evosoro_tpu.core.materials import build_body, calc_max_dt, palette_from_list
    from evosoro_tpu.core.rollout import init_state
    from evosoro_tpu.core.step import sim_step
    from evosoro_tpu.core.types import EnvParams, SimParams, evosoro_default_palette
    from tools.roofline import _count_jaxpr

    n = 10
    rng = np.random.default_rng(0)
    structure = rng.integers(1, 5, size=(n, n, n)).astype(np.int32)
    phase = rng.uniform(-1, 1, size=(n, n, n))
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=phase)
    sim, env = SimParams(), EnvParams()
    dt = float(calc_max_dt(body)) * float(sim.dt_frac)
    state = init_state(body)
    u = jnp.zeros((n, n, n), state.pos.dtype)

    def step(s, c):
        return sim_step(s, body, sim, env, dt, control_offset=c)

    def total(jaxpr):
        counts = {"ew": 0, "trans": 0, "red": 0, "dot": 0}
        _count_jaxpr(jaxpr.jaxpr, counts)
        return sum(counts.values())

    out = jax.eval_shape(step, state, u)
    cot = jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape, x.dtype) if jnp.issubdtype(x.dtype, jnp.floating)
        else np.zeros(x.shape, jax.dtypes.float0), out)
    forward = total(jax.make_jaxpr(step)(state, u))
    both = total(jax.make_jaxpr(lambda s, c, ct: jax.vjp(step, s, c)[1](ct))(state, u, cot))
    np.testing.assert_allclose((forward - 2 * n ** 3) / n ** 3,
                               roofline.STEP_FLOPS_PER_VOXEL, rtol=1e-9)
    np.testing.assert_allclose((both - forward) / n ** 3,
                               roofline.ADJOINT_FLOPS_PER_VOXEL, rtol=1e-9)
