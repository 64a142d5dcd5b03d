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


def test_b4_work_follows_the_variant():
    """B4's count in water and with growth: the forward and adjoint counts
    of the launch's variant for every occupied voxel and step, and with the
    facet drag the robot's surface mesh on every step; development bodies'
    six fields are read as well."""
    B, V, grid, K = 2, 27, (3, 3, 3), 2
    state = torch.zeros(B, fr.C_S, V)
    body = torch.zeros(1, fr.C_B, V)
    occ = torch.zeros(grid)
    occ[:2, :2, :2] = 1.0  # 48 triangles, 26 vertices, 56 corners (as below)
    body[0, fr._B_OCC] = occ.flatten()
    stats = torch.zeros(B, fr.C_STAT)
    ctrl = torch.zeros(B, K, V)
    steps = [10, 4]
    land = roofline.b4_work(state, body, stats, ctrl, steps)
    assert roofline.b4_work(state, body, stats, ctrl, steps, flags={}, grid_shape=grid) == land
    face = roofline.b4_work(state, body, stats, ctrl, steps, flags=dict(fluid=True),
                            grid_shape=grid)
    np.testing.assert_allclose(face[0], 14 * 8 * (roofline.FLUID_FACE_STEP_FLOPS_PER_VOXEL
                                                  + roofline.FLUID_FACE_ADJOINT_FLOPS_PER_VOXEL))
    assert face[1] == land[1]
    mesh = roofline.b4_work(state, body, stats, ctrl, steps,
                            flags=dict(fluid=True, fluid_mesh=True), grid_shape=grid)
    np.testing.assert_allclose(mesh[0], 14 * (
        8 * (roofline.FLUID_MESH_STEP_FLOPS_PER_VOXEL
             + roofline.FLUID_MESH_ADJOINT_FLOPS_PER_VOXEL)
        + 48 * (roofline.MESH_FLOPS_PER_TRIANGLE + roofline.MESH_ADJOINT_FLOPS_PER_TRIANGLE)
        + 26 * (roofline.MESH_FLOPS_PER_VERTEX + roofline.MESH_ADJOINT_FLOPS_PER_VERTEX)
        + 56 * (roofline.MESH_FLOPS_PER_CORNER + roofline.MESH_ADJOINT_FLOPS_PER_CORNER)))
    assert mesh[1] == land[1]  # the tape and the mesh scratch are the kernel's own
    # mesh tables on land are inert
    assert roofline.b4_work(state, body, stats, ctrl, steps, flags=dict(fluid_mesh=True),
                            grid_shape=grid) == land
    devo = roofline.b4_work(state, body, stats, ctrl, steps,
                            flags=dict(use_final_size=True), grid_shape=grid)
    np.testing.assert_allclose(devo[0], 14 * 8 * (roofline.DEVO_STEP_FLOPS_PER_VOXEL
                                                  + roofline.DEVO_ADJOINT_FLOPS_PER_VOXEL))
    assert devo[1] == land[1] + 4.0 * 6 * V


def test_adjoint_operation_counts_in_water_and_with_growth_are_jaxpr_walks():
    """Where B4's counts in water and with growth come from: the walk of
    `test_adjoint_operation_count_is_the_jaxpr_walk_of_the_steps_vjp` (the
    jaxpr of `jax.vjp` of the JAX package's `sim_step` with the control
    offset, less the forward step) on the bodies of
    `test_fluid_and_development_operation_counts_are_jaxpr_walks`: in water
    with the voxel-face drag, with the growth experiment's development
    fields, and with the facet drag on three bodies with different surfaces,
    whose counts fix the per-voxel, per-triangle and per-vertex constants
    exactly, a fourth confirming them; the vertex constant is 8 corner slots
    (a walk of the vjp of `mesh_drag_forces` with the tables cut to 4 and 2
    slots) and a rest."""
    import jax
    import jax.numpy as jnp

    from evosoro_tpu.core.materials import build_body, calc_max_dt, palette_from_list
    from evosoro_tpu.core.rollout import init_state
    from evosoro_tpu.core.step import sim_step
    from evosoro_tpu.core.types import SimParams, evosoro_default_palette
    from evosoro_tpu.envs import aquatic, growth_env
    from evosoro_tpu.envs.drag import attach_mesh_drag, mesh_drag_forces
    from tools.roofline import _count_jaxpr

    def total(jaxpr):
        counts = {"ew": 0, "trans": 0, "red": 0, "dot": 0}
        _count_jaxpr(jaxpr.jaxpr, counts)
        return sum(counts.values())

    def zero_cot(out):
        return jax.tree_util.tree_map(
            lambda x: jnp.zeros(x.shape, x.dtype) if jnp.issubdtype(x.dtype, jnp.floating)
            else np.zeros(x.shape, jax.dtypes.float0), out)

    def adjoint(body, sim, env):
        dt = float(calc_max_dt(body)) * float(sim.dt_frac)
        state = init_state(body)
        u = jnp.zeros(body.occ.shape, state.pos.dtype)

        def step(s, c):
            return sim_step(s, body, sim, env, dt, control_offset=c)

        cot = zero_cot(jax.eval_shape(step, state, u))
        both = total(jax.make_jaxpr(lambda s, c, ct: jax.vjp(step, s, c)[1](ct))(state, u, cot))
        return both - total(jax.make_jaxpr(step)(state, u))

    n = 10
    rng = np.random.default_rng(0)
    structure = rng.integers(1, 5, size=(n, n, n)).astype(np.int32)
    phase = rng.uniform(-1, 1, size=(n, n, n))
    palette = palette_from_list(evosoro_default_palette())
    body = build_body(structure, palette, phase_offset=phase)
    np.testing.assert_allclose(adjoint(body, SimParams(), aquatic()) / n ** 3,
                               roofline.FLUID_FACE_ADJOINT_FLOPS_PER_VOXEL, rtol=1e-9)

    def u(lo, hi):
        return rng.uniform(lo, hi, size=(n, n, n))

    grower = build_body(structure, palette, phase_offset=phase,
                        initial_voxel_size=u(0.006, 0.014),
                        final_voxel_size=u(0.006, 0.014), growth_time=u(1, 2),
                        start_growth_time=u(0, 1))
    np.testing.assert_allclose(
        adjoint(grower, SimParams(min_temp_fact=0.4), growth_env()) / n ** 3,
        roofline.DEVO_ADJOINT_FLOPS_PER_VOXEL, rtol=1e-9)

    rows = []
    for cut in ((None, (slice(2, 5), slice(2, 9), slice(9, 10)),
                 (slice(4, 6), slice(4, 6), slice(4, 6)),
                 (slice(0, 10), slice(3, 4), slice(3, 4)))):
        s = structure.copy()
        if cut is not None:
            s[cut] = 0
        swimmer = attach_mesh_drag(build_body(s, palette, phase_offset=phase))
        tris, verts, _ = roofline.mesh_counts(torch.as_tensor(s > 0)[None])
        rows.append(([n ** 3, int(tris), int(verts)], adjoint(swimmer, SimParams(), aquatic())))
    fit = np.linalg.solve(np.array([r[0] for r in rows[:3]], float),
                          np.array([r[1] for r in rows[:3]], float))
    np.testing.assert_allclose(
        fit, [roofline.FLUID_MESH_ADJOINT_FLOPS_PER_VOXEL,
              roofline.MESH_ADJOINT_FLOPS_PER_TRIANGLE,
              roofline.MESH_TABLE_SLOTS * roofline.MESH_ADJOINT_FLOPS_PER_CORNER
              + roofline.MESH_ADJOINT_FLOPS_PER_VERTEX], rtol=1e-9)
    np.testing.assert_allclose(np.dot(rows[3][0], fit), rows[3][1], rtol=1e-12)

    tables = swimmer.mesh_drag
    shape = s.shape

    def drag_adjoint(slots):
        cut = tables.replace(vert_vox=tables.vert_vox[:, :slots],
                             vert_sign=tables.vert_sign[:, :slots],
                             vert_w=tables.vert_w[:, :slots])
        z = np.zeros

        def f(pos, quat, lin, sp, sn):
            return mesh_drag_forces(pos, quat, np.ones(shape), lin, np.ones(shape), cut,
                                    750.0, strain_pos=sp, strain_neg=sn, nominal_size=0.01)

        args = (z(shape + (3,)), z(shape + (4,)), z(shape + (3,)), z((3,) + shape),
                z((3,) + shape))
        cot = np.zeros(jax.eval_shape(f, *args).shape)
        both = total(jax.make_jaxpr(lambda *a: jax.vjp(f, *a)[1](cot))(*args))
        return both - total(jax.make_jaxpr(f)(*args))

    n_verts = tables.vert_vox.shape[0]
    per_slot = (drag_adjoint(8) - drag_adjoint(4)) / (4 * n_verts)
    assert per_slot == (drag_adjoint(4) - drag_adjoint(2)) / (2 * n_verts)
    assert per_slot == roofline.MESH_ADJOINT_FLOPS_PER_CORNER


def test_mesh_counts_equal_the_gather_tables():
    """Triangles, vertices and live corner slots counted from the occupancy
    with tensor ops against the tables `build_mesh_drag` makes on the host."""
    from evosoro_tpu_torch.envs.drag import mesh_tables

    rng = np.random.default_rng(0)
    structures = rng.integers(0, 3, size=(5, 4, 5, 3))
    counts = roofline.mesh_counts(torch.as_tensor(structures > 0))
    for s, t, v, c in zip(structures, *(x.tolist() for x in counts)):
        tables = mesh_tables(s)
        assert t == int(tables["tri_mask"].sum()) and v == tables["vert_vox"].shape[0]
        assert c == int(tables["vert_w"].sum())
    # a solid 10^3 block: 8 corner vertices of 1 voxel, 12 x 9 on edges of 2,
    # 6 x 81 on faces of 4: 2168 live slots where the padded tables hold 4816
    solid = torch.ones((1, 10, 10, 10), dtype=torch.bool)
    assert [int(x) for x in roofline.mesh_counts(solid)] == [1200, 602, 2168]


def test_fluid_and_development_work_follow_the_launchs_flags():
    B, V, grid = 2, 27, (3, 3, 3)
    state = torch.zeros(B, fr.C_S, V)
    body = torch.zeros(1, fr.C_B, V)
    occ = torch.zeros(grid)
    # a 2^3 block in its shell: 48 triangles, 26 vertices, 8 + 12 x 2 + 6 x 4 corners
    occ[:2, :2, :2] = 1.0
    body[0, fr._B_OCC] = occ.flatten()
    stats = torch.zeros(B, fr.C_STAT)
    stats[:, fr._S_DT] = 0.5
    out = stats.clone()
    out[:, fr._S_TIME] = torch.tensor([5.0, 2.0])  # 10 and 4 steps
    args = (state, body, stats, None, out)
    base = 4.0 * (2 * B * 47 * V + 69 * V + 2 * B * fr.C_STAT)
    land = dict(fluid=False)
    assert roofline.launch_work(*args, flags=land, grid_shape=grid) == \
        roofline.k1_work(*args)
    flops, nbytes = roofline.launch_work(*args, flags=dict(fluid=True), grid_shape=grid)
    np.testing.assert_allclose(flops, 14 * 8 * roofline.FLUID_FACE_STEP_FLOPS_PER_VOXEL)
    assert nbytes == base
    flops, nbytes = roofline.launch_work(*args, flags=dict(fluid=True, fluid_mesh=True),
                                         grid_shape=grid)
    np.testing.assert_allclose(
        flops, 14 * (8 * roofline.FLUID_MESH_STEP_FLOPS_PER_VOXEL
                     + 48 * roofline.MESH_FLOPS_PER_TRIANGLE
                     + 26 * roofline.MESH_FLOPS_PER_VERTEX
                     + 56 * roofline.MESH_FLOPS_PER_CORNER))
    assert nbytes == base  # the strains' scratch is not compulsory traffic
    flops, nbytes = roofline.launch_work(*args, flags=dict(use_final_size=True),
                                         grid_shape=grid)
    np.testing.assert_allclose(flops, 14 * 8 * roofline.DEVO_STEP_FLOPS_PER_VOXEL)
    assert nbytes == base + 4.0 * 6 * V
    assert roofline.b8_work(*args) == (flops, nbytes)


def test_fluid_and_development_operation_counts_are_jaxpr_walks():
    """Where `FLUID_FACE_STEP_FLOPS_PER_VOXEL`, `DEVO_STEP_FLOPS_PER_VOXEL`
    and the facet-drag step's three constants come from: `tools/roofline.py`'s
    jaxpr walk over the JAX package's `sim_step` on the 10^3 bench body, in
    water without and with mesh tables, and with the growth experiment's
    development fields. The facet-drag step's count is linear in the grid's
    voxels, the mesh's triangles and its vertices: three bodies with different
    surfaces fix the three constants, a fourth confirms them. The JAX tables
    pad every vertex to 8 corner slots (`vert_w` 0 on the padding), so the
    vertex constant is 8 slots and a rest: a walk of `mesh_drag_forces` with
    the tables cut to 4 and to 2 slots gives the slot's share, which the bound
    counts once for every LIVE slot (`vert_w.sum()`), and what is left is
    counted once a vertex."""
    import jax

    from evosoro_tpu.core.materials import build_body, calc_max_dt, palette_from_list
    from evosoro_tpu.core.rollout import init_state
    from evosoro_tpu.core.step import sim_step
    from evosoro_tpu.core.types import SimParams, evosoro_default_palette
    from evosoro_tpu.envs import aquatic, growth_env
    from evosoro_tpu.envs.drag import attach_mesh_drag, mesh_drag_forces
    from tools.roofline import _count_jaxpr

    n = 10
    rng = np.random.default_rng(0)
    structure = rng.integers(1, 5, size=(n, n, n)).astype(np.int32)
    phase = rng.uniform(-1, 1, size=(n, n, n))
    palette = palette_from_list(evosoro_default_palette())

    def total(body, sim, env):
        dt = float(calc_max_dt(body)) * float(sim.dt_frac)
        jaxpr = jax.make_jaxpr(lambda s: sim_step(s, body, sim, env, dt))(init_state(body))
        counts = {"ew": 0, "trans": 0, "red": 0, "dot": 0}
        _count_jaxpr(jaxpr.jaxpr, counts)
        return sum(counts.values())

    body = build_body(structure, palette, phase_offset=phase)
    np.testing.assert_allclose(total(body, SimParams(), aquatic()) / n ** 3,
                               roofline.FLUID_FACE_STEP_FLOPS_PER_VOXEL, rtol=1e-9)

    def u(lo, hi):
        return rng.uniform(lo, hi, size=(n, n, n))

    grower = build_body(structure, palette, phase_offset=phase,
                        initial_voxel_size=u(0.006, 0.014),
                        final_voxel_size=u(0.006, 0.014), growth_time=u(1, 2),
                        start_growth_time=u(0, 1))
    np.testing.assert_allclose(
        total(grower, SimParams(min_temp_fact=0.4), growth_env()) / n ** 3,
        roofline.DEVO_STEP_FLOPS_PER_VOXEL, rtol=1e-9)

    rows = []
    cuts = (None, (slice(2, 5), slice(2, 9), slice(9, 10)),
            (slice(4, 6), slice(4, 6), slice(4, 6)),
            (slice(0, 10), slice(3, 4), slice(3, 4)))
    for cut in cuts:
        s = structure.copy()
        if cut is not None:
            s[cut] = 0
        swimmer = attach_mesh_drag(build_body(s, palette, phase_offset=phase))
        tris, verts, corners = roofline.mesh_counts(torch.as_tensor(s > 0)[None])
        assert int(tris) == int(np.asarray(swimmer.mesh_drag.tri_mask).sum())
        assert int(verts) == swimmer.mesh_drag.vert_vox.shape[0]
        assert int(corners) == int(np.asarray(swimmer.mesh_drag.vert_w).sum())
        rows.append(([n ** 3, int(tris), int(verts)],
                     total(swimmer, SimParams(), aquatic())))
    fit = np.linalg.solve(np.array([r[0] for r in rows[:3]], float),
                          np.array([r[1] for r in rows[:3]], float))
    np.testing.assert_allclose(
        fit, [roofline.FLUID_MESH_STEP_FLOPS_PER_VOXEL, roofline.MESH_FLOPS_PER_TRIANGLE,
              roofline.MESH_TABLE_SLOTS * roofline.MESH_FLOPS_PER_CORNER
              + roofline.MESH_FLOPS_PER_VERTEX], rtol=1e-9)
    np.testing.assert_allclose(np.dot(rows[3][0], fit), rows[3][1], rtol=1e-12)

    # the slot's share of the vertex constant: the drag alone on the last
    # swimmer, its tables cut to fewer slots
    tables = swimmer.mesh_drag
    assert tables.vert_vox.shape[1] == roofline.MESH_TABLE_SLOTS
    shape = s.shape

    def drag_total(slots):
        cut = tables.replace(vert_vox=tables.vert_vox[:, :slots],
                             vert_sign=tables.vert_sign[:, :slots],
                             vert_w=tables.vert_w[:, :slots])
        z = np.zeros
        jaxpr = jax.make_jaxpr(lambda pos, quat, lin, sp, sn: mesh_drag_forces(
            pos, quat, np.ones(shape), lin, np.ones(shape), cut, 750.0, strain_pos=sp,
            strain_neg=sn, nominal_size=0.01))(
                z(shape + (3,)), z(shape + (4,)), z(shape + (3,)), z((3,) + shape),
                z((3,) + shape))
        counts = {"ew": 0, "trans": 0, "red": 0, "dot": 0}
        _count_jaxpr(jaxpr.jaxpr, counts)
        return sum(counts.values())

    n_verts = tables.vert_vox.shape[0]
    per_slot = (drag_total(8) - drag_total(4)) / (4 * n_verts)
    assert per_slot == (drag_total(4) - drag_total(2)) / (2 * n_verts)
    assert per_slot == roofline.MESH_FLOPS_PER_CORNER


def test_feature_operation_counts_are_jaxpr_walks():
    """Where the features' counts come from: `tools/roofline.py`'s jaxpr
    walk over the JAX package's functions that compute them, on the 10^3
    bench body, per grid voxel: a trace sample, the fall-over latch's touch
    counts, the end-of-life posterior Y, the needle, one source's distances,
    and the ballistic rebase (its `sim_step` with a DevoState less without)."""
    import jax
    import jax.numpy as jnp

    from evosoro_tpu.core.materials import build_body, calc_max_dt, palette_from_list
    from evosoro_tpu.core.rollout import (_needle_pos, _posterior_y, _touch_counts,
                                          center_of_mass, init_state, total_volume)
    from evosoro_tpu.core.step import sim_step
    from evosoro_tpu.core.types import EnvParams, SimParams, evosoro_default_palette
    from evosoro_tpu.envs.sources import make_sources, min_distances, source_positions
    from tools.roofline import _count_jaxpr

    n = 10
    rng = np.random.default_rng(0)
    structure = rng.integers(1, 5, size=(n, n, n)).astype(np.int32)
    phase = rng.uniform(-1, 1, size=(n, n, n))
    palette = palette_from_list(evosoro_default_palette())

    def walk(f, *args):
        counts = {"ew": 0, "trans": 0, "red": 0, "dot": 0}
        _count_jaxpr(jax.make_jaxpr(f)(*args).jaxpr, counts)
        return sum(counts.values()) / n ** 3

    def u(lo, hi):
        return rng.uniform(lo, hi, size=(n, n, n))

    # one body with development fields serves every walk: the features'
    # counts do not read those fields
    body = build_body(structure, palette, phase_offset=phase,
                      initial_voxel_size=u(0.006, 0.014), final_voxel_size=u(0.006, 0.014),
                      growth_time=u(0.01, 0.1), start_growth_time=u(0, 0.05))
    st = init_state(body)
    src = make_sources([dict(pos=(0.1, 0.01, 0.01), amp=(0.02, 0, 0), freq=(3.0, 0, 0),
                             enabled=True)])
    for got, want in (
            (walk(lambda s: (center_of_mass(s, body)[1], total_volume(s, body)), st),
             roofline.TRACE_SAMPLE_FLOPS_PER_VOXEL),
            (walk(lambda s: _touch_counts(s, body), st), roofline.FALL_LATCH_FLOPS_PER_VOXEL),
            (walk(lambda s: _posterior_y(s, body), st), roofline.EOL_POSTERIOR_FLOPS_PER_VOXEL),
            (walk(lambda s: _needle_pos(s, body), st), roofline.NEEDLE_FLOPS_PER_VOXEL),
            (walk(lambda s, t: min_distances(source_positions(src, t), s, body), st,
                  jnp.asarray(0.1)), roofline.SOURCE_FLOPS_PER_VOXEL)):
        np.testing.assert_allclose(got, want, rtol=1e-9)

    dev = body
    sim, env = SimParams(), EnvParams(growth_amplitude=0.8, num_trace_steps_in_window=4)
    dt = float(calc_max_dt(dev)) * 0.9
    # the step without the DevoState is DEVO_STEP_FLOPS_PER_VOXEL (the walk
    # of test_fluid_and_development_operation_counts_are_jaxpr_walks)
    ballistic = walk(lambda s: sim_step(s, dev, sim, env, dt),
                     init_state(dev, ballistic_devo=True))
    np.testing.assert_allclose(ballistic - roofline.DEVO_STEP_FLOPS_PER_VOXEL,
                               roofline.BALLISTIC_FLOPS_PER_VOXEL, rtol=1e-9)


def test_feature_work_follows_the_launch():
    """The features' work on top of the step's: a sample for each trace a
    robot took, the latch on every step past its IniCM time, a capture
    once; sources on every step; the rebase on every step."""
    B, V = 2, 8
    state = torch.zeros(B, fr.C_S, V)
    body = torch.zeros(1, fr.C_B, V)
    body[0, fr._B_OCC, :5] = 1.0
    stats = torch.zeros(B, fr.C_STAT)
    stats[:, fr._S_DT] = 1.0
    stats[:, fr._S_INITCM] = torch.tensor([3.0, 20.0])  # the second never gets there
    out = stats.clone()
    out[:, fr._S_TIME] = 10.0
    out[:, fr._S_NTR] = torch.tensor([4.0, 0.0])
    out[:, fr._S_EOLCAP] = torch.tensor([1.0, 0.0])
    flags = dict(falling=True, ndbv=True)
    flops, nbytes = roofline.b8c_work(body, stats, out, flags)
    per = (4 * roofline.TRACE_SAMPLE_FLOPS_PER_VOXEL + 7 * roofline.FALL_LATCH_FLOPS_PER_VOXEL
           + roofline.EOL_POSTERIOR_FLOPS_PER_VOXEL)
    np.testing.assert_allclose(flops, 5 * per)
    assert nbytes == 4.0 * 2 * B * 18
    np.testing.assert_allclose(roofline.b8d_work(body, stats, out, 3)[0],
                               2 * 10 * 5 * 3 * roofline.SOURCE_FLOPS_PER_VOXEL)
    np.testing.assert_allclose(roofline.b8b_work(body, stats, out)[0],
                               2 * 10 * 5 * roofline.BALLISTIC_FLOPS_PER_VOXEL)
    base = roofline.launch_work(state, body, stats, None, out, flags=dict(use_final_size=True),
                                grid_shape=(2, 2, 2))
    both = roofline.launch_work(state, body, stats, None, out,
                                flags=dict(flags, use_final_size=True, ballistic=True),
                                grid_shape=(2, 2, 2), scalars=dict(sources=((0.0,) * 9,)))
    np.testing.assert_allclose(
        both[0] - base[0], flops + roofline.b8b_work(body, stats, out)[0]
        + roofline.b8d_work(body, stats, out, 1)[0])


def test_material_and_compact_operation_counts_are_jaxpr_walks():
    """Where the material instance's and the compact contact pass's counts
    come from: `tools/roofline.py`'s jaxpr walk of the JAX package's
    `sim_step` on the 10^3 bench body with each option on, beyond the land
    step (bilinear stress with plasticity; the clamp with BC regions, which
    the land count already holds; equilibrium mode); and the compact
    contact pass's walk, the one-hot products aside, equal to the dense
    pass's on a grid of the surface's size, whose pairs K2's counts charge
    (14 tested, 8 more touching, and 3 a voxel for the sums' signs)."""
    import jax
    import jax.numpy as jnp

    import evosoro_tpu.core.types as jt
    from evosoro_tpu.core.materials import build_body, calc_max_dt, palette_from_list
    from evosoro_tpu.core.rollout import init_state
    from evosoro_tpu.core.step import sim_step
    from evosoro_tpu.ops.fused_rollout import _pair_contact_forces, _pair_contact_forces_compact
    from tools.roofline import _count_jaxpr

    n = 10
    rng = np.random.default_rng(0)
    structure = rng.integers(1, 5, size=(n, n, n)).astype(np.int32)
    phase = rng.uniform(-1, 1, size=(n, n, n))

    def walk(jaxpr):
        counts = {"ew": 0, "trans": 0, "red": 0, "dot": 0}
        _count_jaxpr(jaxpr.jaxpr, counts)
        return counts

    def per_voxel(mats=None, sim=None, **kw):
        body = build_body(structure, palette_from_list(mats or jt.evosoro_default_palette()),
                          phase_offset=phase, **kw)
        sim = sim or jt.SimParams()
        dt = float(calc_max_dt(body)) * 0.9
        c = walk(jax.make_jaxpr(lambda s: sim_step(s, body, sim, jt.EnvParams(), dt))(
            init_state(body)))
        return sum(c.values()) / n ** 3 - roofline.STEP_FLOPS_PER_VOXEL

    mats = list(jt.evosoro_default_palette())
    mats[2] = jt.Material(3, "m", 5e6, cte=0.01, mat_model=jt.MDL_BILINEAR,
                          yield_stress=1e5, plastic_mod=1e6)

    np.testing.assert_allclose(per_voxel(), 0.0, atol=1e-9)
    np.testing.assert_allclose(per_voxel(mats, jt.SimParams(plasticity_enabled=True)),
                               roofline.NONLINEAR_FLOPS_PER_VOXEL
                               + roofline.PLASTIC_FLOPS_PER_VOXEL, rtol=1e-9)
    dof = np.zeros((n, n, n), np.int32)
    dof[0] = jt.DOF_ALL
    np.testing.assert_allclose(
        per_voxel(sim=jt.SimParams(max_velocity_enabled=True), dof_fixed=dof),
        roofline.MAX_VEL_FLOPS_PER_VOXEL + roofline.MAX_VEL_FLOPS_PER_STEP / n ** 3,
        rtol=1e-9)
    np.testing.assert_allclose(per_voxel(sim=jt.SimParams(equilibrium_mode=True)),
                               roofline.EQUILIBRIUM_FLOPS_PER_STEP / n ** 3, rtol=1e-9)

    Vp, Sp = 256, 128
    c = walk(jax.make_jaxpr(lambda p0, p1, p2, s, pk: _pair_contact_forces_compact(
        (p0, p1, p2), s, pk, Vp, jnp.float32))(
        *(jnp.zeros((1, Vp)) for _ in range(4)), jnp.zeros((Vp + Sp, Sp))))
    d = walk(jax.make_jaxpr(lambda p0, p1, p2, s, a: _pair_contact_forces(
        (p0, p1, p2), s, a, jnp.float32))(
        *(jnp.zeros((1, Sp)) for _ in range(4)), jnp.zeros((Sp, Sp))))
    compact = c["ew"] + c["trans"] + c["red"]
    assert compact == d["ew"] + d["trans"] + d["red"] and d["dot"] == 0
    assert compact == ((roofline.PAIR_FLOPS_TESTED + roofline.PAIR_FLOPS_TOUCHING) * Sp * Sp
                       + 3 * Sp)


def test_material_and_compact_work_follow_the_launch():
    B, V = 2, 8
    state = torch.zeros(B, fr.C_S, V)
    body = torch.zeros(1, fr.C_B, V)
    body[0, fr._B_OCC, :6] = 1.0
    stats = torch.zeros(B, fr.C_STAT)
    stats[:, fr._S_DT] = 0.5
    out = stats.clone()
    out[:, fr._S_TIME] = torch.tensor([5.0, 2.0])  # 10 and 4 steps
    args = (state, body, stats, None, out)
    base = roofline.k1_work(*args)
    # on the 2^3 grid (strides 4, 2, 1): voxels 0 and 4 MDL_DATA, voxel 1
    # linear; bond 0-4 homogeneous (one curve evaluation), bond 0-1 not
    # (four at voxel 0, none at the linear voxel 1), bond 2-3 between two
    # linear voxels (none)
    body[0, fr._B_MATMODEL, [0, 4]] = 3.0
    for v, d, hom in ((0, 0, 1.0), (0, 2, 0.0), (2, 2, 0.0)):
        body[0, fr._B_DIR + d * fr._B_PER_DIR + fr._D_MASK, v] = 1.0
        body[0, fr._B_DIR + d * fr._B_PER_DIR + fr._D_HOM, v] = hom
    assert roofline.mdl_lookups(body, (2, 2, 2)).tolist() == [5.0]
    flags = dict(nonlinear=True, mdl_data=True, plasticity=True, max_vel=True, bc=True)
    flops, nbytes = roofline.launch_work(*args, flags=flags, grid_shape=(2, 2, 2), n_pts=5)
    per = (roofline.NONLINEAR_FLOPS_PER_VOXEL + roofline.PLASTIC_FLOPS_PER_VOXEL
           + roofline.MAX_VEL_FLOPS_PER_VOXEL)
    lookups = 5 * (roofline.MDL_FLOPS_PER_LOOKUP + 3 * roofline.MDL_FLOPS_PER_POINT)
    np.testing.assert_allclose(flops - base[0],
                               14 * (6 * per + lookups + roofline.MAX_VEL_FLOPS_PER_STEP))
    assert nbytes - base[1] == 4.0 * ((4 + 13 + 15) * V + 2 * 3 * B * V)
    # equilibrium mode turns the clamp off
    eq, _ = roofline.b6_work(body, stats, out, dict(equilibrium=True, max_vel=True), (2, 2, 2))
    assert eq == 14 * roofline.EQUILIBRIUM_FLOPS_PER_STEP
    # the compact pass in place of the dense one: its nonzero entries and surface
    table = torch.zeros(1, 4, 3)
    table[0, 0] = torch.tensor([0.0, 2.0, 5.0])
    table[0, 1, 1] = table[0, 2, 0] = 1.0
    flops, nbytes = roofline.launch_work(state, body, stats, table, out,
                                         flags=dict(collision=True, collision_compact=True),
                                         grid_shape=(2, 2, 2))
    np.testing.assert_allclose(flops - base[0], 14 * 2 * roofline.PAIR_FLOPS_TESTED)
    assert nbytes - base[1] == 4.0 * 12


def test_volume_operation_count_is_a_jaxpr_walk():
    """Where `VOLUME_FLOPS_PER_VOXEL` and `VOLUME_FLOPS_PER_STEP` come from:
    `tools/roofline.py`'s jaxpr walk of the JAX package's `sim_step` with
    volume effects on (and their carry in the state) beyond the land step,
    under `EnvParams()`'s varying temperature, on bench bodies of 6^3 and
    8^3: 194 per voxel and 19 a robot fit both exactly."""
    import jax

    import evosoro_tpu.core.types as jt
    from evosoro_tpu.core.materials import build_body, calc_max_dt, palette_from_list
    from evosoro_tpu.core.rollout import init_state
    from evosoro_tpu.core.step import sim_step
    from tools.roofline import _count_jaxpr

    def walk(n, vol):
        rng = np.random.default_rng(0)
        structure = rng.integers(1, 5, size=(n, n, n)).astype(np.int32)
        body = build_body(structure, palette_from_list(jt.evosoro_default_palette()),
                          phase_offset=rng.uniform(-1, 1, size=(n, n, n)))
        sim = jt.SimParams(volume_effects_enabled=vol)
        dt = float(calc_max_dt(body, vol)) * 0.9
        counts = {"ew": 0, "trans": 0, "red": 0, "dot": 0}
        _count_jaxpr(jax.make_jaxpr(lambda s: sim_step(s, body, sim, jt.EnvParams(), dt))(
            init_state(body, volume_effects=vol)).jaxpr, counts)
        return sum(counts.values())

    for n in (6, 8):
        np.testing.assert_allclose(
            (walk(n, True) - walk(n, False)) / n ** 3,
            roofline.VOLUME_FLOPS_PER_VOXEL + roofline.VOLUME_FLOPS_PER_STEP / n ** 3,
            rtol=1e-12)


def test_volume_work_follows_the_launch():
    """A volume launch is counted from its step count (`volume_clock`): a
    robot that ends live took them all, one that froze as many as its span
    holds at its larger dt; `b6d_work` adds its operations and the carry's
    and the body's volume channels."""
    B, V = 2, 8
    state = torch.zeros(B, fr.C_S, V)
    body = torch.zeros(1, fr.C_B, V)
    body[0, fr._B_OCC, :6] = 1.0
    stats = torch.zeros(B, fr.C_STAT)
    stats[:, fr._S_DT] = 0.5
    stats[:, fr._S_STOP] = torch.tensor([float("inf"), 2.0])
    out = stats.clone()
    out[:, fr._S_TIME] = torch.tensor([4.0, 2.0])
    out[:, fr._S_DT] = torch.tensor([0.4, 0.5])
    flags = dict(volume=True)
    with pytest.raises(ValueError, match="num_steps"):
        roofline.launch_work(state, body, stats, None, out, flags=flags, grid_shape=(2, 2, 2))
    clock = roofline.volume_clock(stats, out, 10)
    assert roofline.steps_taken(clock, out).tolist() == [10.0, 4.0]
    flops, nbytes = roofline.launch_work(state, body, stats, None, out, flags=flags,
                                         grid_shape=(2, 2, 2), num_steps=10)
    base = roofline.k1_work(state, body, clock, None, out)
    per = 6 * roofline.VOLUME_FLOPS_PER_VOXEL + roofline.VOLUME_FLOPS_PER_STEP
    np.testing.assert_allclose(flops - base[0], 14 * per)
    assert nbytes - base[1] == 4.0 * (3 * V + 2 * 6 * B * V)
    # with the nonlinear stress, Young's modulus is read once
    _, nb = roofline.b6d_work(state, body, clock, out, dict(flags, nonlinear=True))
    assert nb == 4.0 * (2 * V + 2 * 6 * B * V)


def test_material_adjoint_operation_counts_are_jaxpr_walks():
    """Where B4's material instance's counts come from: the walk of
    `test_adjoint_operation_count_is_the_jaxpr_walk_of_the_steps_vjp` (the
    jaxpr of `jax.vjp` of the JAX package's `sim_step` with the control
    offset, less the forward step) on the 10^3 bench body, on the bilinear
    palette (`bench.bilinear_palette`) and with the max-velocity clamp,
    beyond the land adjoint: 213 and 22 per occupied voxel and step, with
    the forward counts of `test_material_and_compact_operation_counts_are_
    jaxpr_walks` beside them."""
    import jax
    import jax.numpy as jnp

    import evosoro_tpu.core.types as jt
    from evosoro_tpu.core.materials import build_body, calc_max_dt, palette_from_list
    from evosoro_tpu.core.rollout import init_state
    from evosoro_tpu.core.step import sim_step
    from test_torch_fused_diff_materials import j_bilinear_palette
    from tools.roofline import _count_jaxpr

    n = 10
    rng = np.random.default_rng(0)
    structure = rng.integers(1, 5, size=(n, n, n)).astype(np.int32)
    phase = rng.uniform(-1, 1, size=(n, n, n))

    def total(jaxpr):
        counts = {"ew": 0, "trans": 0, "red": 0, "dot": 0}
        _count_jaxpr(jaxpr.jaxpr, counts)
        return sum(counts.values())

    def walks(mats, sim):
        """(forward, adjoint) counts of the step with the control offset."""
        body = build_body(structure, palette_from_list(mats), phase_offset=phase)
        dt = float(calc_max_dt(body)) * 0.9
        state = init_state(body)
        u = jnp.zeros((n, n, n), state.pos.dtype)

        def step(s, c):
            return sim_step(s, body, sim, jt.EnvParams(), dt, control_offset=c)

        out = jax.eval_shape(step, state, u)
        cot = jax.tree_util.tree_map(
            lambda x: jnp.zeros(x.shape, x.dtype) if jnp.issubdtype(x.dtype, jnp.floating)
            else np.zeros(x.shape, jax.dtypes.float0), out)
        forward = total(jax.make_jaxpr(step)(state, u))
        both = total(jax.make_jaxpr(lambda s, c, ct: jax.vjp(step, s, c)[1](ct))(state, u,
                                                                                 cot))
        return forward, both - forward

    V = n ** 3
    linear = list(jt.evosoro_default_palette())
    f0, a0 = walks(linear, jt.SimParams())
    np.testing.assert_allclose(a0 / V, roofline.ADJOINT_FLOPS_PER_VOXEL, rtol=1e-9)
    f1, a1 = walks(j_bilinear_palette(), jt.SimParams())
    np.testing.assert_allclose((f1 - f0) / V, roofline.NONLINEAR_FLOPS_PER_VOXEL, rtol=1e-9)
    assert a1 - a0 == roofline.NONLINEAR_ADJOINT_FLOPS_PER_VOXEL * V
    f2, a2 = walks(linear, jt.SimParams(max_velocity_enabled=True))
    assert f2 - f0 == roofline.MAX_VEL_FLOPS_PER_VOXEL * V + roofline.MAX_VEL_FLOPS_PER_STEP
    assert a2 - a0 == roofline.MAX_VEL_ADJOINT_FLOPS_PER_VOXEL * V


def test_b4_work_on_the_material_instance():
    """B4's count on a bilinear palette and with the clamp: the forward and
    adjoint counts of each option on top of the land ones for every
    occupied voxel and step, the clamp's share a robot every step; the
    nonlinear stress reads the four material channels of the body. In water
    (and with development) the options add the same counts on top of the
    variant's."""
    B, V, K = 2, 8, 2
    state = torch.zeros(B, fr.C_S, V)
    body = torch.zeros(1, fr.C_B, V)
    body[0, fr._B_OCC, :6] = 1.0
    stats = torch.zeros(B, fr.C_STAT)
    ctrl = torch.zeros(B, K, V)
    steps = [10, 4]
    land = roofline.b4_work(state, body, stats, ctrl, steps)
    nl = roofline.b4_work(state, body, stats, ctrl, steps, flags=dict(nonlinear=True))
    np.testing.assert_allclose(nl[0] - land[0], 14 * 6 * (
        roofline.NONLINEAR_FLOPS_PER_VOXEL + roofline.NONLINEAR_ADJOINT_FLOPS_PER_VOXEL))
    assert nl[1] - land[1] == 4.0 * roofline.MATERIAL_BODY_CHANNELS * V
    mv = roofline.b4_work(state, body, stats, ctrl, steps, flags=dict(max_vel=True))
    np.testing.assert_allclose(mv[0] - land[0], 14 * (
        6 * (roofline.MAX_VEL_FLOPS_PER_VOXEL + roofline.MAX_VEL_ADJOINT_FLOPS_PER_VOXEL)
        + roofline.MAX_VEL_FLOPS_PER_STEP))
    assert mv[1] == land[1]
    both = roofline.b4_work(state, body, stats, ctrl, steps,
                            flags=dict(nonlinear=True, max_vel=True))
    np.testing.assert_allclose(both[0] - land[0], (nl[0] - land[0]) + (mv[0] - land[0]))
    # in water the material instance adds the same counts as on land
    water_nl = roofline.b4_work(state, body, stats, ctrl, steps,
                                flags=dict(nonlinear=True, fluid=True), grid_shape=(2, 2, 4))
    water = roofline.b4_work(state, body, stats, ctrl, steps, flags=dict(fluid=True),
                             grid_shape=(2, 2, 4))
    np.testing.assert_allclose(water_nl[0] - water[0], nl[0] - land[0])
    assert water_nl[1] - water[1] == nl[1] - land[1]
