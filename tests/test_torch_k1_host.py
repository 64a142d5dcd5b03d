"""K1's fluid and development variants, checked without a card.

`ops/csrc/fused_rollout_common.cuh` compiled for the host by g++
(`tests/cuda_host/`: one thread a block, barriers as no-ops; the fixture of
tests/test_torch_b4_host.py) runs the step loop in the variant the launch's
flags select: voxel-face drag, facet drag on the deformed mesh (the
corner-lattice stencil), the land_water actuation, the development ramps.
Each is held against `fused_rollout_plain` over the eager step, whose facet
drag is the gather/scatter formulation of `envs/drag.py`: an independent
statement of the same function. This checks arithmetic and indexing, not
barriers or the thread mapping: those are held on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerance: every channel group within 1e-4 of the group's largest plain
value over 40 steps, as tests/test_torch_b4_host.py holds the land step
(g++'s libm is not torch's; the facet sums run in another order). Each case
also shows what the check can see: the other drag model, a zero drag
coefficient and cleared development flags land far outside it.
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_b4_host import GROUPS, host_forward, host_lib  # noqa: F401

from evosoro_tpu_torch import bench
from evosoro_tpu_torch.core import types as pt
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)
REL_TOL = 1e-4
STEPS = 40


def _worst(got, ref, skip=()):
    """Largest error of any carried channel group (but those in `skip`)
    over the group's largest plain value."""
    worst = 0.0
    for name, (a, b) in list(GROUPS.items())[:-1]:
        if name in skip:
            continue
        top = float(ref[:, a:b].abs().max())
        err = float((got[:, a:b] - ref[:, a:b]).abs().max())
        worst = max(worst, err / top if top > 0 else err)
    return worst


def _host(lib, args, kw, steps=STEPS):
    state, body, stats, _ = args
    ctrl = torch.zeros((state.shape[0], 1, state.shape[2]))
    return host_forward(lib, state, body, stats, ctrl, 0,
                        dict(kw, num_steps=steps, n_knots=0, total_steps=steps))


def _punch_holes(args, kw, seed=5):
    """The bench design with a few voxels taken out, so the mesh has inner
    faces, vertices with fewer than 8 voxels and bonds that end in nothing."""
    from evosoro_tpu_torch.core import (build_body, calc_max_dt, evosoro_default_palette,
                                        init_state, palette_from_list)
    from evosoro_tpu_torch.envs.drag import attach_mesh_drag

    state, body, stats, _ = args
    X, Y, Z = kw["grid_shape"]
    rng = np.random.default_rng(seed)
    mat = body[0, fr._B_MAT].reshape(X, Y, Z).numpy().astype(np.int32)
    holes = rng.random(mat.shape) < 0.2
    holes[0, 0, 0] = False
    mat = np.where(holes, 0, mat)
    new = build_body(mat, palette_from_list(evosoro_default_palette()),
                     phase_offset=body[0, fr._B_PHASE].reshape(X, Y, Z).numpy())
    if kw["flags"]["fluid_mesh"]:
        new = attach_mesh_drag(new)
    B = state.shape[0]
    st = fr.pack_state_single(init_state(new))[None].expand(B, -1, -1).contiguous()
    stats = stats.clone()
    stats[:, fr._S_DT] = float(calc_max_dt(new)) * 0.9
    stats[:, fr._S_INV_MASS] = 1.0 / float(new.mass.sum())
    return (st, fr.pack_body(new), stats, None), kw


@pytest.mark.parametrize("model,holes", [("face", False), ("face", True),
                                         ("mesh", False), ("mesh", True)])
def test_host_compiled_fluid_step_matches_plain(host_lib, model, holes):  # noqa: F811
    """At the swimming experiment's drag coefficient (750) the drag moves a
    voxel by about as much as g++'s libm moves it against torch's, so the
    step is also held at 200 times that coefficient, where drag weighs as
    much as elasticity: there the other drag model and a launch without
    drag land two orders outside the tolerance."""
    args, kw, _ = bench.packed_workload(3, n=4, device="cpu", fluid=model)
    if holes:
        args, kw = _punch_holes(args, kw)
    assert kw["flags"]["fluid"] and kw["flags"]["fluid_mesh"] == (model == "mesh")
    state, body, stats, _ = args
    for coefficient in (bench.AGGREGATE_DRAG_COEF, 200 * bench.AGGREGATE_DRAG_COEF):
        stats = stats.clone()
        stats[:, fr._S_DRAGC] = coefficient
        args = (state, body, stats, None)
        out_h, st_h = _host(host_lib, args, kw)
        out_p, st_p = fr.fused_call(*args, num_steps=STEPS, **kw)
        assert float(out_p[:, fr._LIN:fr._LIN + 3].abs().max()) > 0  # it swims
        assert _worst(out_h, out_p) <= REL_TOL
        torch.testing.assert_close(st_h[:, :fr._S_STOP], st_p[:, :fr._S_STOP],
                                   rtol=1e-6, atol=1e-9)
    no_drag = stats.clone()
    no_drag[:, fr._S_DRAGC] = 0.0
    out_0, _ = _host(host_lib, (state, body, no_drag, None), kw)
    assert _worst(out_0, out_p) > 100 * REL_TOL
    # the other drag model on the same shelled grid
    other = dict(kw, flags=dict(kw["flags"], fluid_mesh=model != "mesh"))
    assert _worst(_host(host_lib, args, other)[0], out_p) > 100 * REL_TOL


def test_host_compiled_fluid_step_on_the_evaluators_batch(host_lib):  # noqa: F811
    """The swimming experiment's own batch (6³ designs in their 7³ shell, a
    body and dt per robot, IniCM times staggered so robots start actuating
    on different steps), contact off: the emulation has no pair pass."""
    args, kw = bench.evaluator_workload(pop_size=3, collision=False, stagger=True,
                                        device="cpu", experiment="swimming")
    assert kw["grid_shape"] == (7, 7, 7) and kw["flags"]["fluid_mesh"]
    assert args[1].shape[0] == args[0].shape[0] == 8
    out_h, _ = _host(host_lib, args, kw, steps=30)
    out_p, _ = fr.fused_call(*args, num_steps=30, **kw)
    assert float(out_p[:, fr._LIN:fr._LIN + 3].abs().max()) > 0
    assert _worst(out_h, out_p) <= REL_TOL


@pytest.mark.parametrize("freeze", [False, True])
def test_host_compiled_development_step_matches_plain(host_lib, freeze):  # noqa: F811
    """Random initial and final sizes, growth windows, final phase offsets
    and amplitude dampings; IniCM time at step 30 of 100, so the prenatal
    ramp, its end, the growth ramp and (with `freeze`) the frozen clock and
    the actuation pause are all inside the launch."""
    args, kw, _ = bench.packed_workload(3, n=4, device="cpu", devo=True, freeze=freeze)
    flags = kw["flags"]
    assert all(flags[k] for k in fr._K1_DEVO_FLAGS) and flags["freeze_on"] == freeze
    out_h, st_h = _host(host_lib, args, kw, steps=100)
    out_p, st_p = fr.fused_call(*args, num_steps=100, **kw)
    scale = out_p[:, fr._SCALE]
    assert float((scale - 0.01).abs().max()) > 1e-3  # the bodies grew
    assert _worst(out_h, out_p) <= REL_TOL
    torch.testing.assert_close(st_h[:, :fr._S_STOP], st_p[:, :fr._S_STOP],
                               rtol=1e-6, atol=1e-9)
    # cleared development flags: the land step on the same tensors differs
    land = dict(kw, flags=dict(flags, **{k: False for k in fr._K1_DEVO_FLAGS}))
    assert _worst(_host(host_lib, args, land, steps=100)[0], out_p) > 100 * REL_TOL


def test_host_compiled_development_step_on_the_evaluators_batch(host_lib):  # noqa: F811
    """The growth experiment's own batch: 5×5×4 bodies, sizes and growth
    windows from `devo_params_from_vxa`, a body per robot. These all-muscle
    blocks barely rotate, so their rotation vectors and angular momenta are
    small beside the rounding noise of the two libms: the rotational groups
    are held at 2e-3, the scale (the ramps' own output) bit for bit."""
    args, kw = bench.evaluator_workload(pop_size=3, collision=False, stagger=True,
                                        device="cpu", experiment="growth")
    assert kw["grid_shape"] == (5, 5, 4)
    assert kw["flags"]["use_init_size"] and kw["flags"]["use_final_size"]
    out_h, _ = _host(host_lib, args, kw, steps=100)
    out_p, _ = fr.fused_call(*args, num_steps=100, **kw)
    assert float((out_p[:, fr._SCALE] - 0.01).abs().max()) > 1e-4
    rotational = ("quat", "angmom", "last_angle1", "last_angle2")
    assert _worst(out_h, out_p, skip=rotational) <= REL_TOL
    for name in rotational:
        a, b = GROUPS[name]
        assert float((out_h[:, a:b] - out_p[:, a:b]).abs().max()) \
            <= 2e-3 * float(out_p[:, a:b].abs().max())
    assert torch.equal(out_h[:, fr._SCALE], out_p[:, fr._SCALE])


# the feature channels the comparison holds exactly (counters, latches,
# times, minima; the state is held by `_worst`) and those it holds at the
# group tolerance (sums over voxels, in another order here than torch's;
# sums of source minima inherit the positions' libm differences)
_FEAT_EXACT = (fr._S_NTR, fr._S_LASTTR, fr._S_WCNT, fr._S_LASTWIN, fr._S_FELL, fr._S_NCAP,
               fr._S_EOLCAP, fr._S_SRC + 6)
_FEAT_SUMS = (fr._S_ND, fr._S_NDRG, fr._S_NDFZ, fr._S_WLAST, fr._S_WPREV, fr._S_EOLY,
              fr._S_NEEDLE, fr._S_NEEDLE + 1, fr._S_NEEDLE + 2, fr._S_SRC, fr._S_SRC + 1,
              fr._S_SRC + 2, fr._S_SRC + 3, fr._S_SRC + 4, fr._S_SRC + 5)


@pytest.mark.parametrize("n_win,n_src", [(4, 3), (12, 1)])
def test_host_compiled_features_match_plain(host_lib, n_win, n_src):  # noqa: F811
    """K1's feature instance (`bench.feature_workload`: the evaluator's
    batch with a needle and feet in each design, half the robots falling
    over at once and leaving the loop with one dry step, NormDistByVol with
    the frozen window, windows of `n_win`, `n_src` sources) against the
    plain version over 45 steps (5 traces), contact off: the state at the group
    tolerance (the rotational groups, which the two libms move apart faster
    on these actuated designs, at 2e-3 as on the growth batch above),
    counters and latches equal, the feature sums within 1e-6 lattice units
    (the robots that stand still sum rounding noise) and 1e-4 of their
    largest value. A launch with the features off leaves their channels as
    they were."""
    args, kw = bench.feature_workload(n_win=n_win, n_src=n_src, collision=False,
                                      device="cpu", pop_size=3)
    out_h, st_h = _host(host_lib, args, kw, steps=45)
    out_p, st_p = fr.fused_call(*args, num_steps=45, **kw)
    rotational = ("quat", "angmom", "last_angle1", "last_angle2")
    assert _worst(out_h, out_p, skip=rotational) <= REL_TOL
    for name in rotational:
        a, b = GROUPS[name]
        assert float((out_h[:, a:b] - out_p[:, a:b]).abs().max()) \
            <= 2e-3 * float(out_p[:, a:b].abs().max())
    assert float((st_p[:, fr._S_FELL] > 0.5).sum()) > 0 and float(st_p[:, fr._S_NTR].max()) >= 5
    for ch in _FEAT_EXACT:
        assert torch.equal(st_h[:, ch], st_p[:, ch]), ch
    for ch in _FEAT_SUMS:
        top = float(st_p[:, ch].abs().max())
        assert float((st_h[:, ch] - st_p[:, ch]).abs().max()) <= 1e-6 + REL_TOL * top, ch
    plain = dict(kw, flags={k: v for k, v in kw["flags"].items()
                            if k not in fr._K1_FEATURE_FLAGS},
                 scalars=dict(kw["scalars"], sources=()))
    _, st_0 = _host(host_lib, args, plain, steps=45)
    assert torch.equal(st_0[:, fr._S_SRC:], args[2][:, fr._S_SRC:])


@pytest.mark.parametrize("slowdown", [0.0, 1.0])
def test_host_compiled_ballistic_matches_plain(host_lib, slowdown):  # noqa: F811
    """Ballistic development on the growth batch (`bench.ballistic_workload`,
    contact off: the emulation has no pair pass; a trace every 2 steps, 60
    steps: every robot rebases from step ~36).
    With slowdown 0 the rebase keeps each final size, so no decision hangs
    on a comparison of two window distances and the devo channels agree bit
    for bit; with 1 every decrease of the windowed speed halts development,
    and a window distance that g++'s libm moves by an ulp against torch's
    can flip a robot's decision, so only the robots whose windows agree to
    1e-3 are held, and there are some."""
    args, kw = bench.ballistic_workload(device="cpu", pop_size=3, collision=False,
                                        trace_steps=2, slowdown=slowdown)
    out_h, st_h = _host(host_lib, args, kw, steps=60)
    out_p, st_p = fr.fused_call(*args, num_steps=60, **kw)
    dd = slice(fr._DEVO_DYN, fr._DEVO_DYN + 4)
    assert float((out_p[:, dd] - args[0][:, dd]).abs().max()) > 0  # rebased
    assert torch.equal(st_h[:, fr._S_WCNT], st_p[:, fr._S_WCNT])
    if slowdown == 0.0:
        assert torch.equal(out_h[:, dd], out_p[:, dd])
        assert _worst(out_h, out_p, skip=("quat", "angmom", "last_angle1", "last_angle2")) \
            <= REL_TOL
        return
    same = ((st_h[:, fr._S_WLAST] - st_p[:, fr._S_WLAST]).abs()
            <= 1e-3 * st_p[:, fr._S_WLAST].abs()) & \
        ((st_h[:, fr._S_WPREV] - st_p[:, fr._S_WPREV]).abs()
         <= 1e-3 * st_p[:, fr._S_WPREV].abs())
    assert bool(same.any())
    torch.testing.assert_close(out_h[same][:, dd], out_p[same][:, dd], rtol=1e-5, atol=0.0)


def test_host_compiled_features_in_water_match_plain(host_lib):  # noqa: F811
    """The feature instance of the facet-drag variant (the swimming
    experiment's batch in its 7^3 shell, a body per robot) with the needle,
    NormDistByVol, windows of 4 and 2 sources (the fall-over latch counts no
    floor in water): the state at the group tolerance with the rotational
    groups at 2e-3, as above; counters equal."""
    (state, body, stats, table), kw = bench.evaluator_workload(
        pop_size=3, collision=False, stagger=True, device="cpu", experiment="swimming")
    kw = bench.with_features(kw, stats, n_win=4, n_src=2, freeze=False)
    args = (state, body, stats, None)
    out_h, st_h = _host(host_lib, args, kw, steps=40)
    out_p, st_p = fr.fused_call(*args, num_steps=40, **kw)
    rotational = ("quat", "angmom", "last_angle1", "last_angle2")
    assert _worst(out_h, out_p, skip=rotational) <= REL_TOL
    for name in rotational:
        a, b = GROUPS[name]
        assert float((out_h[:, a:b] - out_p[:, a:b]).abs().max()) \
            <= 2e-3 * float(out_p[:, a:b].abs().max())
    for ch in (fr._S_NTR, fr._S_WCNT, fr._S_NCAP, fr._S_SRC + 6):
        assert torch.equal(st_h[:, ch], st_p[:, ch]), ch
    assert float(st_p[:, fr._S_NTR].max()) >= 3


# K1's material instance (the land variant with Voxelyze's material, solver
# and boundary options), built by g++ as above and held against the plain
# version; the state at the group tolerance with the rotational groups at
# 2e-3 (the two libms), and plasticity's strain offset, state channels
# 53-55, at the group tolerance
_SOFF_GROUP = (fr._SOFF, fr._SOFF + 3)


def _host_mat(lib, args, kw, steps):
    lib.emu_fwd_mat.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    state, body, stats, _ = args
    B, X, Y, Z = state.shape[0], *kw["grid_shape"]
    flags = kw["flags"]
    scalars = fr.equilibrium_scalars(kw["scalars"]) if flags.get("equilibrium") \
        else kw["scalars"]
    params = fr._k1_params(scalars, fr.DEFAULT_PRECISION)
    fparams = fr._feat_params(kw["scalars"], flags)
    mparams = fr._mat_params(kw["scalars"])
    ss, bc = kw.get("ss_packed"), kw.get("bc_packed")
    st, sa = state.clone(), stats.clone()
    lib.emu_fwd_mat(st.data_ptr(), body.data_ptr(), int(body.shape[0] == B and B > 1),
                    sa.data_ptr(), B, X, Y, Z, steps, params.ctypes.data,
                    fr._flag_bits(flags), fparams.ctypes.data,
                    ss.data_ptr() if ss is not None else None,
                    int(ss is not None and ss.shape[0] == B and B > 1),
                    (ss.shape[1] - 3) // 2 if ss is not None else 0,
                    bc.data_ptr() if bc is not None else None,
                    int(bc is not None and bc.shape[0] == B and B > 1), mparams.ctypes.data)
    return st, sa


def _mat_worst(out_h, out_p):
    rotational = ("quat", "angmom", "last_angle1", "last_angle2")
    worst = _worst(out_h, out_p, skip=rotational)
    for name in rotational:
        a, b = GROUPS[name]
        top = float(out_p[:, a:b].abs().max())
        worst = max(worst, float((out_h[:, a:b] - out_p[:, a:b]).abs().max()) / top / 20
                    if top > 0 else 0.0)
    a, b = _SOFF_GROUP
    top = float(out_p[:, a:b].abs().max())
    if top > 0:
        worst = max(worst, float((out_h[:, a:b] - out_p[:, a:b]).abs().max()) / top)
    return worst


def _equilibrium_moving(B=3, n=4, seed=2):
    """The bench design (n^3) in equilibrium mode, free of floor and
    gravity, starting with random momenta: its energy falls and the mode's
    zeroing fires within the first steps."""
    args, kw, _ = bench.packed_workload(B, n=n, device="cpu", equilibrium=True)
    state, body, stats, table = args
    state = state.clone()
    rng = np.random.default_rng(seed)
    occ = body[0, fr._B_OCC] > 0.5
    lin = torch.as_tensor(rng.normal(0, 1e-3, size=(B, 3, n ** 3)), dtype=torch.float32)
    state[:, fr._LIN:fr._LIN + 3] = torch.where(occ, lin, 0.0)
    flags = dict(kw["flags"], gravity=False, floor=False, temp=False, temp_enabled=False)
    return (state, body, stats, table), dict(kw, flags=flags)


@pytest.mark.parametrize("case", ["materials", "equilibrium", "cantilever", "features"])
def test_host_compiled_material_instance_matches_plain(host_lib, case, tmp_path):  # noqa: F811
    """The materials experiment's own batch (bilinear muscle, MDL_DATA tissue,
    a body and MDL_DATA table per robot) with plasticity and the max-velocity
    clamp, contact off (the emulation has no pair pass); the same with every
    fitness feature (the material instance's feature instance); equilibrium
    mode on a moving body, held where the ring decides; the hand-written
    cantilever read with `load_vxa`, whose pinned face stays at its nominal
    place bit for bit. A guard each: the branch's bit cleared (or the
    cantilever's BC channels dropped) lands far outside the tolerance."""
    steps = 40
    if case in ("materials", "features"):
        args, kw = bench.materials_workload(pop_size=3, collision=False, device="cpu")
        if case == "features":
            kw = bench.with_features(kw, args[2], n_win=4, n_src=1, freeze=False)
        guard = dict(kw, flags=dict(kw["flags"], nonlinear=False, mdl_data=False),
                     ss_packed=None)
    elif case == "equilibrium":
        args, kw = _equilibrium_moving()
        guard = dict(kw, flags=dict(kw["flags"], equilibrium=False))
    else:
        args, kw, body = bench.cantilever_workload(str(tmp_path / "cantilever.vxa"),
                                                   batch=2, n=4, device="cpu")
        guard = dict(kw, flags=dict(kw["flags"], bc=False), bc_packed=None)
    out_h, st_h = _host_mat(host_lib, args, kw, steps)
    out_p, st_p = fr.fused_call(*args, num_steps=steps, **kw)
    assert _mat_worst(out_h, out_p) <= REL_TOL
    torch.testing.assert_close(st_h[:, :fr._S_STOP], st_p[:, :fr._S_STOP], rtol=1e-6, atol=1e-9)
    out_g, _ = _host_mat(host_lib, args, guard, steps)
    assert _mat_worst(out_g, out_p) > 100 * REL_TOL
    if case == "materials":
        assert float(out_p[:, fr._SOFF:fr._SOFF + 3].abs().max()) > 0  # plastic
    if case == "features":
        assert torch.equal(st_h[:, fr._S_NTR], st_p[:, fr._S_NTR])
        assert float(st_p[:, fr._S_NTR].max()) >= 1
    if case == "equilibrium":
        ke = slice(fr._S_KE, fr._S_KE + 6)
        torch.testing.assert_close(st_h[:, ke], st_p[:, ke], rtol=1e-3, atol=0.0)
    if case == "cantilever":
        occ = body.occ.flatten()
        pinned = ((body.dof_fixed == pt.DOF_ALL).flatten()) & occ
        nom = body.nom_pos.reshape(-1, 3).T + body.external_disp.reshape(-1, 3).T
        for out in (out_h, out_p):
            assert torch.equal(out[:, fr._POS:fr._POS + 3][:, :, pinned],
                               nom[:, pinned].expand(2, -1, -1))


# K1's step loop (`csrc/k1_step.cuh`: bond items, the state resident in
# shared memory, the reductions' fixed partition) in its three forms, built
# by g++ (`emu_set_step`: 0 the tape form B4's recompute runs, out of place
# into a tape of whole-state slots, the robot's state then the slot of its
# last step; 1 in place; 2 with the state resident past the buffer). The
# forms change only where a step reads and writes the state, so the three
# must agree bit for bit in every instance, and the tape's clocks must be
# the in-place run's. One thread a block here: this holds the bond-item
# indexing, the tape's slots and carried channels, the resident copy in and
# out and the buffer's carve, not the thread mapping (the card's
# `chip_smoke.py --step` and `--land` digests hold that).
_MODES = (0, 1, 2)


def _squeezed(args, factors=(0.6, 0.7)):
    """The state with each robot's occupied voxels pulled toward their centre,
    so far surface voxels touch and the pair pass has work."""
    state, body, stats, table = args
    occ = body[0, fr._B_OCC] > 0.5
    state = state.clone()
    for b in range(state.shape[0]):
        p = state[b, fr._POS:fr._POS + 3]
        c = p[:, occ].mean(1, keepdim=True)
        f = factors[b % len(factors)]
        state[b, fr._POS:fr._POS + 3] = torch.where(occ, c + f * (p - c), p)
    return state, body, stats, table


def _stirred(args, seed=3):
    """The state with random momenta and small turns on every occupied voxel,
    so that every channel of the pose and momenta moves within a few steps."""
    state, body, stats, table = args
    rng = np.random.default_rng(seed)
    occ = body[:, fr._B_OCC] > 0.5
    state = state.clone()
    B, _, V = state.shape
    for ch, sd in ((fr._LIN, 1e-4), (fr._ANG, 1e-6)):
        kick = torch.as_tensor(rng.normal(0, sd, size=(B, 3, V)), dtype=torch.float32)
        state[:, ch:ch + 3] = state[:, ch:ch + 3] + torch.where(occ[:, None], kick, 0.0)
    q = torch.cat([torch.ones((B, 1, V)), torch.as_tensor(
        rng.normal(0, 2e-2, size=(B, 3, V)), dtype=torch.float32)], 1)
    q = q / q.norm(dim=1, keepdim=True)
    state[:, fr._QUAT:fr._QUAT + 4] = torch.where(occ[:, None], q, state[:, fr._QUAT:fr._QUAT + 4])
    return state, body, stats, table


def _host_any(lib, args, kw, steps):
    """One emulated K1 launch through the entry its flags take: the material
    and volume instances through `emu_fwd_vol` (with the dense or compact
    pair table when given), contact through `emu_fwd_contact`, the rest
    through `emu_fwd`."""
    P, I = ctypes.c_void_p, ctypes.c_int
    state, body, stats, table = args
    B, X, Y, Z = state.shape[0], *kw["grid_shape"]
    flags = kw["flags"]
    if not any(flags.get(k) for k in fr._K1_MAT_FLAGS):
        if table is None:
            return _host(lib, args, kw, steps)
        lib.emu_fwd_contact.argtypes = [P, P, I, P, P] + [I] * 8 + [P, I, P, P, I]
        st, sa = state.clone(), stats.clone()
        lib.emu_fwd_contact(st.data_ptr(), body.data_ptr(), int(body.shape[0] == B and B > 1),
                            sa.data_ptr(), torch.zeros((B, 1, X * Y * Z)).data_ptr(), 0, steps,
                            0, B, X, Y, Z, steps,
                            fr._k1_params(kw["scalars"], fr.DEFAULT_PRECISION).ctypes.data,
                            fr._flag_bits(flags), fr._feat_params(kw["scalars"], flags)
                            .ctypes.data, table.data_ptr(), int(table.shape[0] == B and B > 1))
        return st, sa
    lib.emu_fwd_vol.argtypes = [P, P, I, P, P, I] + [I] * 6 + [P, I, P, P, I, I, P, I, P, P]
    scalars = fr.equilibrium_scalars(kw["scalars"]) if flags.get("equilibrium") \
        else kw["scalars"]
    ss, bc = kw.get("ss_packed"), kw.get("bc_packed")

    def batched(t):
        return int(t is not None and t.shape[0] == B and B > 1)

    st, sa = state.clone(), stats.clone()
    lib.emu_fwd_vol(st.data_ptr(), body.data_ptr(), batched(body), sa.data_ptr(),
                    table.data_ptr() if table is not None else None, batched(table),
                    table.shape[-1] if flags.get("collision_compact") else 0, B, X, Y, Z, steps,
                    fr._k1_params(scalars, fr.DEFAULT_PRECISION).ctypes.data,
                    fr._flag_bits(flags), fr._feat_params(kw["scalars"], flags).ctypes.data,
                    ss.data_ptr() if ss is not None else None, batched(ss),
                    (ss.shape[1] - 3) // 2 if ss is not None else 0,
                    bc.data_ptr() if bc is not None else None, batched(bc),
                    fr._mat_params(kw["scalars"]).ctypes.data,
                    fr._vol_params(kw["scalars"]).ctypes.data)
    return st, sa


def _step_case(case):
    """(args, kw) of each instance at 3^3-5^3, two robots."""
    if case == "land":
        args, kw, _ = bench.packed_workload(2, n=4, device="cpu")
    elif case == "land_contact":
        args, kw, _ = bench.packed_workload(2, n=5, collision=True, device="cpu")
        args = _squeezed(args)
    elif case in ("face", "facet"):
        args, kw, _ = bench.packed_workload(2, n=3, device="cpu",
                                            fluid="face" if case == "face" else "mesh")
    elif case == "development":
        args, kw, _ = bench.packed_workload(2, n=4, device="cpu", devo=True, freeze=True)
    elif case == "features":
        args, kw, _ = bench.packed_workload(2, n=4, collision=True, device="cpu")
        kw = bench.with_features(kw, args[2], n_win=4, n_src=3, freeze=True)
        args = _squeezed(args)
    elif case == "material":
        args, kw, _ = bench.packed_workload(2, n=4, device="cpu", materials=True)
    elif case == "equilibrium":
        args, kw = _equilibrium_moving(B=2)
    elif case == "compact":
        args, kw, _ = bench.packed_workload(2, n=5, collision=True, compact=True,
                                            device="cpu")
        args = _squeezed(args)
    else:
        args, kw, _ = bench.packed_workload(2, n=4, collision=True, device="cpu", volume=True)
        args = _squeezed(args, (0.75, 0.8))
    return _stirred(args), kw


@pytest.mark.parametrize("case", ["land", "land_contact", "face", "facet", "development",
                                  "features", "material", "equilibrium", "compact",
                                  "volume"])
def test_new_step_loop_is_bit_equal_to_the_old(host_lib, case):  # noqa: F811
    """Each instance over 25 steps through the step loop's tape form (the
    tape's last slot), in place and with the resident state: state and
    stats equal bit for bit, and the launch moved every robot (a loop that
    skipped its steps would agree with nothing). The tape's clock of step
    i (`tape_t`) is the in-place run's time after i steps, bit for bit, at
    i = 0, 1, 12 and each robot's last step."""
    args, kw = _step_case(case)
    X, Y, Z = kw["grid_shape"]
    assert X * Y * Z <= 6 ** 3
    runs = []
    B, steps = args[0].shape[0], 25
    clock, taken = torch.zeros((B, steps)), torch.zeros(B, dtype=torch.int32)
    host_lib.emu_tape_clock.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    try:
        for mode in _MODES:
            host_lib.emu_set_step(mode)
            runs.append(_host_any(host_lib, args, kw, steps))
            if mode == 0:
                assert host_lib.emu_tape_clock(clock.data_ptr(), taken.data_ptr(), steps) == B
        host_lib.emu_set_step(1)
        for i in sorted({0, 1, 12, *(int(n) - 1 for n in taken)}):
            t_i = (_host_any(host_lib, args, kw, i)[1] if i else args[2])[:, fr._S_TIME]
            for b in range(B):
                if i < int(taken[b]):
                    assert clock[b, i].item() == t_i[b].item(), (case, b, i)
    finally:
        host_lib.emu_set_step(1)
    state = args[0]
    moved = (runs[0][0] != state).any(2)
    assert bool(moved[:, fr._POS:fr._SCALE].all())  # pose and momenta, every channel
    for st, sa in runs[1:]:
        assert torch.equal(st, runs[0][0])
        assert torch.equal(sa, runs[0][1])
