"""The reverse-mode segment kernel's arithmetic, checked without a card.

`ops/csrc/fused_rollout_bwd.cu` (B4) and the step loop it shares with K1
(`fused_rollout_common.cuh`) are compiled for the host by g++ with
stand-ins for the CUDA built-ins (`tests/cuda_host/`: one thread a block,
barriers and shuffles as no-ops) and held against the plain versions:
the forward loop against `fused_rollout_plain`, the hand-written adjoint
against `fused_bwd_plain` (torch autograd through the eager step). This
checks the device functions' arithmetic and branch conventions, not the
launch, the thread mapping or the shared-memory traffic: those are held on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerance: every channel group of both cotangents within 2e-4 of the
group's largest plain value (measured worst 5.2e-5; the two sum the same
float32 terms in different orders, and g++'s libm is not torch's).
"""

import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from evosoro_tpu_torch.core import (
    EnvParams,
    SimParams,
    build_body,
    calc_max_dt,
    evosoro_default_palette,
    init_state,
    palette_from_list,
)
from evosoro_tpu_torch.ops import build
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 2e-4
GROUPS = dict(pos=(0, 3), quat=(3, 7), linmom=(7, 10), angmom=(10, 13),
              scale=(13, 14), small=(14, 17), last_pos2=(17, 26),
              last_angle1=(26, 35), last_angle2=(35, 44), max_strain=(44, 47),
              unused=(47, 64))
_P, _I = ctypes.c_void_p, ctypes.c_int


def emulation_library(*defines, opt="-O1"):
    """`tests/cuda_host/emulate.cpp` (the kernels' sources with stand-ins for
    the CUDA built-ins) built by g++ into a shared library. It is built once
    for all test files and pytest workers: under `evosoro_tpu_torch/_build/
    cuda_host/`, named by a hash of the sources (every file of
    `tests/cuda_host/` and `ops/csrc/`) and of the command line, under a
    file lock the workers share (`build.gxx_library`), g++ held to 120 s."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels' sources for the host")
    cuda_host = os.path.join(HERE, "cuda_host")
    flags = ["-std=c++17", opt, "-ffp-contract=off", "-x", "c++", "-shared", "-fPIC",
             "-DEVOSORO_HOST_EMULATION", *defines, "-I", cuda_host, "-I", str(build.CSRC)]
    inputs = [os.path.join(cuda_host, f) for f in os.listdir(cuda_host)] + \
        [str(f) for f in build.CSRC.iterdir()]
    return ctypes.CDLL(str(build.gxx_library(
        "emulate", [os.path.join(cuda_host, "emulate.cpp")], flags, inputs=inputs,
        directory=build.BUILD_DIR / "cuda_host", timeout=120)))


@pytest.fixture(scope="module")
def host_lib():
    """The kernels' sources built for the host into a shared library."""
    lib = emulation_library()
    lib.emu_fwd.argtypes = [_P, _P, _I, _P, _P] + [_I] * 8 + [_P, _I, _P]
    lib.emu_bwd.argtypes = [_P, _P, _I, _P, _P] + [_I] * 8 + [_P, _I, _P, _P, _P, _P, _P, _I]
    return lib


def _launch_args(state, body, kw):
    X, Y, Z = kw["grid_shape"]
    B = state.shape[0]
    bits = fr._flag_bits(kw["flags"])
    params = fr._k1_params(kw["scalars"], fr.DEFAULT_PRECISION)
    return B, X, Y, Z, bits, params, int(body.shape[0] == B and B > 1)


def host_forward(lib, state, body, stats, ctrl, seg_base, kw):
    B, X, Y, Z, bits, params, batched = _launch_args(state, body, kw)
    fparams = fr._feat_params(kw["scalars"], kw["flags"])
    st, sa = state.clone(), stats.clone()
    lib.emu_fwd(st.data_ptr(), body.data_ptr(), batched, sa.data_ptr(), ctrl.data_ptr(),
                kw["n_knots"], kw["total_steps"], seg_base, B, X, Y, Z,
                kw["num_steps"], params.ctypes.data, bits, fparams.ctypes.data)
    return st, sa


def host_backward(lib, state, body, stats, ctrl, seg_base, cot, kw, cluster=1, tape_out=None):
    """B4 built by g++ on these inputs, each robot a cluster of `cluster`
    blocks (one thread standing for them all); with `tape_out` a list, the
    recompute's tape and clocks are appended to it."""
    B, X, Y, Z, bits, params, batched = _launch_args(state, body, kw)
    S, V = kw["num_steps"], X * Y * Z
    tape = torch.empty((B, S + 1, fr.b4_tape_channels(kw["flags"]), V))
    tape_t = torch.empty((B, S))
    cs, cu = cot.clone(), torch.zeros_like(ctrl)
    mparams = fr._mat_params(kw["scalars"])
    lib.emu_bwd(state.data_ptr(), body.data_ptr(), batched, stats.data_ptr(),
                ctrl.data_ptr(), kw["n_knots"], kw["total_steps"], seg_base, B, X, Y, Z,
                S, params.ctypes.data, bits, tape.data_ptr(), tape_t.data_ptr(),
                cs.data_ptr(), cu.data_ptr(), mparams.ctypes.data, cluster)
    if tape_out is not None:
        tape_out += [tape, tape_t]
    return cs, cu


def _worst(got, ref):
    """Largest error of any channel group over the group's largest plain value."""
    worst = 0.0
    for a, b in GROUPS.values():
        top = float(ref[0][:, a:b].abs().max())
        err = float((got[0][:, a:b] - ref[0][:, a:b]).abs().max())
        worst = max(worst, err / top if top > 0 else err)
    top = float(ref[1].abs().max())
    err = float((got[1] - ref[1]).abs().max())
    return max(worst, err / top if top > 0 else err)


# name -> settings of `_case`
CASES = {
    "rest_one_step": dict(pre=0, seg_base=0, S=1, holes=False),
    "rest_free": dict(pre=0, seg_base=0, S=6, holes=False,
                      env=dict(gravity_enabled=False, floor_enabled=False)),
    "holes_floor_gravity": dict(),
    "sticky_floor": dict(env=dict(sticky_floor=True), pre=60, seg_base=60, total=96),
    "large_angles": dict(perturb=0.3, S=4),
    "large_angles_free": dict(perturb=0.3, S=4,
                              env=dict(gravity_enabled=False, floor_enabled=False)),
    "stop_mid_segment_and_frozen": dict(stop_after=3),
    "actuation_clamps": dict(clamp=True),
    "body_per_robot": dict(per_robot=True),
    "zero_cotangent": dict(zero_cot=True),
}


def _case(n=4, B=3, S=6, K=3, total=48, seg_base=20, pre=20, env=None, holes=True,
          perturb=0.0, stop_after=None, clamp=False, per_robot=False, zero_cot=False):
    """(state, body, stats, ctrl, seg_base, cot, kw) of one backward launch:
    `pre` steps into a rollout under random controls, then optionally
    perturbed (random displacements, rotations and momenta: bonds leave the
    small-angle frame), with a stop time inside the segment for robot 0 and
    before it for robot 1, or with bounds that make the actuation clamps
    keep the old scale."""
    rng = np.random.default_rng(0)
    palette = palette_from_list(evosoro_default_palette())
    env = EnvParams(**(env or {}))
    sim = SimParams(init_cm_time=0.0)

    def design(seed):
        r = np.random.default_rng(seed)
        structure = r.integers(0 if holes else 1, 5, size=(n, n, n)).astype(np.int32)
        structure[:, :, 0] = np.maximum(structure[:, :, 0], 1)
        return build_body(structure, palette, phase_offset=r.uniform(-1, 1, size=(n, n, n)),
                          device="cpu")

    bodies = [design(10 * i) for i in range(B if per_robot else 1)]
    dt = min(float(calc_max_dt(b)) for b in bodies) * sim.dt_frac
    of = (lambda i: bodies[i]) if per_robot else (lambda i: bodies[0])
    state = torch.stack([fr.pack_state_single(init_state(of(i))) for i in range(B)])
    body = torch.cat([fr.pack_body(b) for b in bodies]).contiguous()
    stats = torch.cat([fr.make_stats(of(i), 1, dt, sim, env) for i in range(B)])
    kw = dict(num_steps=S, grid_shape=(n, n, n),
              scalars=fr.kernel_scalars(bodies[0].nominal_size, sim, env),
              flags=dict(fr.kernel_env_flags(sim, env), **fr.body_flags(bodies[0]),
                         collision=False, segmented=True),
              n_knots=K, total_steps=total)
    if clamp:
        stats[:, fr._S_MINTF] = 0.9995
        stats[:, fr._S_GAMP] = 5e-4
    V = n ** 3
    ctrl = torch.as_tensor(rng.uniform(-0.3, 0.3, size=(B, K, V)).astype(np.float32))
    if pre:
        state, stats = fr.fused_rollout_plain(state, body, stats, None, control_packed=ctrl,
                                              seg_base=0, **dict(kw, num_steps=pre))
    if perturb:
        def noise(c):
            return torch.as_tensor(rng.standard_normal((B, c, V)).astype(np.float32))

        state = state.clone()
        state[:, 0:3] += noise(3) * perturb * bodies[0].nominal_size
        q = state[:, 3:7] + noise(4) * perturb * 3
        state[:, 3:7] = q / q.norm(dim=1, keepdim=True)
        for a, b in ((7, 10), (10, 13)):
            state[:, a:b] += noise(3) * perturb * 3 * state[:, a:b].abs().max().clamp(min=1e-9)
    if stop_after is not None:
        stats = stats.clone()
        stats[0, fr._S_STOP] = stats[0, fr._S_TIME] + (stop_after + 0.5) * dt
        stats[1, fr._S_STOP] = stats[1, fr._S_TIME] - dt  # frozen from the start
    cot = torch.as_tensor(rng.standard_normal((B, fr.C_S, V)).astype(np.float32))
    if zero_cot:
        cot.zero_()
    return state.contiguous(), body, stats.contiguous(), ctrl, seg_base, cot, kw


@pytest.mark.parametrize("name", list(CASES))
def test_host_compiled_adjoint_matches_autograd(host_lib, name):
    state, body, stats, ctrl, seg_base, cot, kw = _case(**CASES[name])
    got = host_backward(host_lib, state, body, stats, ctrl, seg_base, cot, kw)
    ref = fr.fused_bwd_plain(state, body, stats, ctrl, seg_base, cot, **kw)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert bool((got[0][:, fr._TSAVG:] == 0).all())
    assert bool((got[0][:, fr._SMALL:fr._SMALL + 3] == 0).all())
    if name == "zero_cotangent":
        assert bool((got[0] == 0).all()) and bool((got[1] == 0).all())
        return
    assert float(ref[1].abs().max()) > 0
    assert _worst(got, ref) <= REL_TOL
    if name == "stop_mid_segment_and_frozen":
        # the frozen robot's segment is the identity
        assert torch.equal(got[0][1, :fr._SMALL], cot[1, :fr._SMALL])
        assert bool((got[1][1] == 0).all())
    # what the check can see: a launch one step short, and the controls'
    # cotangent moved to the neighbouring knot, are far outside the tolerance
    short = host_backward(host_lib, state, body, stats, ctrl, seg_base, cot,
                          dict(kw, num_steps=kw["num_steps"] - 1))
    if kw["num_steps"] > 1 and name != "stop_mid_segment_and_frozen":
        assert _worst(short, ref) > 100 * REL_TOL
    assert _worst((got[0], torch.roll(got[1], 1, dims=1)), ref) > 100 * REL_TOL


def test_host_compiled_forward_matches_plain_and_covers_the_branches(host_lib):
    """The shared step loop, in place (K1's use of it), against the plain
    version over 20 steps from rest and 6 more from a perturbed state; the
    inputs reach the large-angle frame, floor contact and empty cells."""
    for name in ("holes_floor_gravity", "large_angles"):
        state, body, stats, ctrl, seg_base, _, kw = _case(**CASES[name])
        out_h, st_h = host_forward(host_lib, state, body, stats, ctrl, seg_base, kw)
        out_p, st_p = fr.fused_call(state, body, stats, None, control_packed=ctrl,
                                    seg_base=seg_base, **kw)
        for a, b in list(GROUPS.values())[:-1]:
            top = float(out_p[:, a:b].abs().max())
            assert float((out_h[:, a:b] - out_p[:, a:b]).abs().max()) <= 1e-4 * max(top, 1e-30)
        torch.testing.assert_close(st_h[:, :fr._S_STOP], st_p[:, :fr._S_STOP],
                                   rtol=1e-6, atol=1e-9)
        bonds = torch.stack([body[:, fr._B_DIR + d * fr._B_PER_DIR] for d in range(3)], 1) > 0.5
        large = bonds & ~(out_p[:, fr._SMALL:fr._SMALL + 3] > 0.5)
        occ = body[:, fr._B_OCC] > 0.5
        assert int(large.sum()) > 0 and int((~occ).sum()) > 0
        pen = 0.5 * out_p[:, fr._SCALE] - out_p[:, fr._POS + 2]
        assert int(((pen > 0) & occ).sum()) > 0


def test_a_changed_header_renames_every_library(tmp_path, monkeypatch):
    """Libraries are named by a hash of every file under `csrc/`, so an edit
    to a header that K1 and B4 share rebuilds both."""
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    monkeypatch.setattr(build, "CSRC", src)
    before = {name: build._lib_path(name) for name in build.SIGNATURES}
    assert "fused_rollout_bwd" in before
    with open(src / "fused_rollout_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: build._lib_path(name) for name in build.SIGNATURES}
    assert all(before[name] != after[name] for name in before)


# water at 200 x the swimming experiment's drag coefficient (the drag's
# adjoint weighs in 6 steps), from momenta perturbed so that facets face
# forward on every side; development under clamp bounds that keep the old
# scale now and then
VARIANT_CASES = {"fluid_face": dict(model="face"), "fluid_mesh": dict(model="mesh"),
                 "growth": dict(model="devo")}


def _variant_case(model, B=3, n=3, S=6, K=3, total=48, pre=20):
    """(state, body, stats, ctrl, seg_base, cot, kw) of one backward launch of
    the bench design in water (`bench.packed_workload(fluid=)`: a 3^3 design
    in its 4^3 shell) or with development fields (`devo=True`), `pre` steps
    into a rollout under random controls."""
    from evosoro_tpu_torch import bench

    rng = np.random.default_rng(1)
    fluid = None if model == "devo" else model
    (state, body, stats, _), kw0, _ = bench.packed_workload(B, n=n, device="cpu",
                                                            fluid=fluid, devo=fluid is None)
    kw = dict(num_steps=S, grid_shape=kw0["grid_shape"], scalars=kw0["scalars"],
              flags=dict(kw0["flags"], segmented=True), n_knots=K, total_steps=total)
    stats = stats.clone()
    if fluid:
        stats[:, fr._S_DRAGC] = 1.5e5
    else:
        stats[:, fr._S_MINTF] = 0.9995
        stats[:, fr._S_GAMP] = 5e-4
    V = state.shape[2]
    ctrl = torch.as_tensor(rng.uniform(-0.3, 0.3, size=(B, K, V)).astype(np.float32))
    state, stats = fr.fused_rollout_plain(state, body, stats, None, control_packed=ctrl,
                                          seg_base=0, **dict(kw, num_steps=pre))
    if fluid:
        occ = (body[:, fr._B_OCC] > 0.5).float()
        state = state.clone()
        for a, b in ((7, 10), (10, 13)):
            noise = torch.as_tensor(rng.standard_normal((B, 3, V)).astype(np.float32))
            state[:, a:b] += 3 * noise * state[:, a:b].abs().max() * occ[:, None]
    cot = torch.as_tensor(rng.standard_normal((B, fr.C_S, V)).astype(np.float32))
    return state.contiguous(), body, stats.contiguous(), ctrl, pre, cot, kw


@pytest.mark.parametrize("name", list(VARIANT_CASES))
def test_host_compiled_adjoint_in_water_and_with_growth(host_lib, name):
    """B4's fluid and development instances (the voxel-face drag, the facet
    drag with its mesh passes, the development clamps) against autograd
    through the plain version, at the land cases' tolerance. What the check
    can see: the plain version with the drag's force (or the scale update)
    detached from the graph, which drops exactly the new adjoint, is far
    outside it, and so is a launch one step short."""
    from unittest import mock

    from evosoro_tpu_torch.core import step as step_mod
    from evosoro_tpu_torch.envs import drag as drag_mod

    model = VARIANT_CASES[name]["model"]
    state, body, stats, ctrl, seg_base, cot, kw = _variant_case(model)
    assert fr.b4_tape_channels(kw["flags"]) == (54 if model == "mesh" else 48)
    got = host_backward(host_lib, state, body, stats, ctrl, seg_base, cot, kw)
    ref = fr.fused_bwd_plain(state, body, stats, ctrl, seg_base, cot, **kw)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert bool((got[0][:, fr._TSAVG:] == 0).all())
    assert _worst(got, ref) <= REL_TOL
    if model == "devo":
        orig = step_mod._scale_update
        target = (step_mod, "_scale_update",
                  lambda *a: (orig(*a)[0].detach(), orig(*a)[1]))
    elif model == "face":
        orig = step_mod._fluid_drag
        target = (step_mod, "_fluid_drag", lambda *a: orig(*a).detach())
    else:
        orig = drag_mod.mesh_drag_forces
        target = (drag_mod, "mesh_drag_forces", lambda *a, **k: orig(*a, **k).detach())
    with mock.patch.object(*target):
        dropped = fr.fused_bwd_plain(state, body, stats, ctrl, seg_base, cot, **kw)
    assert _worst(got, dropped) > 20 * REL_TOL
    short = host_backward(host_lib, state, body, stats, ctrl, seg_base, cot,
                          dict(kw, num_steps=kw["num_steps"] - 1))
    assert _worst(short, ref) > 100 * REL_TOL


def _material_case(pre, B=3, n=4, S=6, K=4, total=48):
    """(state, body, stats, ctrl, seg_base, cot, kw) of one backward launch of
    the gradient-MPC benchmark on materials (`bench.sqp_workload(materials=
    True)`: the bench design on the bilinear palette with the max-velocity
    clamp, without floor and gravity) at 4^3, `pre` steps into a rollout
    under random controls."""
    from evosoro_tpu_torch import bench

    rng = np.random.default_rng(2)
    body, sim, env, dt = bench.sqp_workload(n=n, device="cpu", materials=True)
    kw = dict(num_steps=S, grid_shape=(n, n, n),
              scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=fr.launch_flags(body, sim, env, collision=False, segmented=True),
              n_knots=K, total_steps=total)
    V = n ** 3
    state = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
    bp = fr.pack_body(body)
    stats = fr.make_stats(body, B, dt, sim, env)
    ctrl = torch.as_tensor(rng.uniform(-0.1, 0.1, size=(B, K, V)).astype(np.float32))
    if pre:
        state, stats = fr.fused_rollout_plain(state, bp, stats, None, control_packed=ctrl,
                                              seg_base=0, **dict(kw, num_steps=pre))
    cot = torch.as_tensor(rng.standard_normal((B, fr.C_S, V)).astype(np.float32))
    return state.contiguous(), bp, stats.contiguous(), ctrl, pre, cot, kw


def material_guards():
    """The two defects the material instance's check must see, as plain
    versions patched with `mock.patch.object`: the nonlinear stress's
    slope replaced by the linear stiffness (the value kept), and the
    max-velocity clamp's factor detached (the projection dropped)."""
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


def branch_counts(fn):
    """(result of fn(), bond-steps past a bilinear side's yield strain,
    voxel-steps the max-velocity clamp scaled back) of the plain version's
    steps that `fn` runs."""
    from unittest import mock

    from evosoro_tpu_torch.core import step as step_mod

    nonlinear, clamp = step_mod._nonlinear_stress, step_mod._max_vel_clamp
    counts = [0, 0]

    def past(mm, ys, e, sv):
        return (mm == 2) & (sv > step_mod._safe_div(ys, e))

    def counted_stress(d, strain, body):
        out = nonlinear(d, strain, body)
        nbr = step_mod._nbr
        side = (body.mat_model_vox, body.yield_stress, body.e_mod)
        yielded = past(*side, out[1]) | past(*(nbr(a, d) for a in side), out[2])
        counts[0] += int((yielded & body.bond_mask[..., d, :, :, :]).sum())
        return out

    def counted_clamp(disp, limit):
        counts[1] += int((step_mod._safe_norm(*disp.unbind(-1)) > limit).sum())
        return clamp(disp, limit)

    with mock.patch.object(step_mod, "_nonlinear_stress", counted_stress), \
            mock.patch.object(step_mod, "_max_vel_clamp", counted_clamp):
        out = fn()
    return out, counts[0], counts[1]


@pytest.mark.parametrize("pre", [0, 20], ids=["from_rest", "20_steps_in"])
def test_host_compiled_material_adjoint_matches_autograd(host_lib, pre):
    """B4's material instance (bilinear stress through the 3-iteration
    stress equalization, the max-velocity clamp) against autograd through
    the plain version, at the land cases' tolerance, with both branches
    exercised (muscle bonds past their yield strain, clamped voxels). What
    the check can see: the plain version with the stress's slope replaced
    by the linear stiffness, or with the clamp's factor detached, is far
    outside it, and so is a launch one step short."""
    from unittest import mock

    state, body, stats, ctrl, seg_base, cot, kw = _material_case(pre)
    assert kw["flags"]["nonlinear"] and kw["flags"]["max_vel"]
    got = host_backward(host_lib, state, body, stats, ctrl, seg_base, cot, kw)
    ref, yielded, clamped = branch_counts(
        lambda: fr.fused_bwd_plain(state, body, stats, ctrl, seg_base, cot, **kw))
    assert yielded > 0 and clamped > 0
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert bool((got[0][:, fr._TSAVG:] == 0).all())
    assert _worst(got, ref) <= REL_TOL
    for _, module, attr, fn in material_guards():
        with mock.patch.object(module, attr, fn):
            wrong = fr.fused_bwd_plain(state, body, stats, ctrl, seg_base, cot, **kw)
        assert _worst(got, wrong) > 20 * REL_TOL
    short = host_backward(host_lib, state, body, stats, ctrl, seg_base, cot,
                          dict(kw, num_steps=kw["num_steps"] - 1))
    assert _worst(short, ref) > 100 * REL_TOL


# B4's recompute (`b4_recompute`: K1's step loop in its tape form) against
# K1's own in-place step built by g++ (`emu_fwd`, `emu_fwd_mat_knots`): the
# land, voxel-face, facet-drag, development and material instances
RECOMPUTE_CASES = {"land": lambda: _case(**CASES["holes_floor_gravity"]),
                   "fluid_face": lambda: _variant_case("face"),
                   "fluid_mesh": lambda: _variant_case("mesh"),
                   "growth": lambda: _variant_case("devo"),
                   "material": lambda: _material_case(20)}


def _k1_in_place(lib, state, body, stats, ctrl, seg_base, kw):
    """K1's in-place step built by g++ over kw's steps: the material instance
    (with knots) when the nonlinear or the clamp's bit is on, else the
    variant the flags select."""
    if not any(kw["flags"].get(k) for k in ("nonlinear", "max_vel")):
        return host_forward(lib, state, body, stats, ctrl, seg_base, kw)
    B, X, Y, Z, bits, params, batched = _launch_args(state, body, kw)
    lib.emu_fwd_mat_knots.argtypes = [_P, _P, _I, _P, _P] + [_I] * 8 + [_P, _I, _P]
    st, sa = state.clone(), stats.clone()
    lib.emu_fwd_mat_knots(st.data_ptr(), body.data_ptr(), batched, sa.data_ptr(),
                          ctrl.data_ptr(), kw["n_knots"], kw["total_steps"], seg_base, B, X, Y,
                          Z, kw["num_steps"], params.ctypes.data, bits,
                          fr._mat_params(kw["scalars"]).ctypes.data)
    return st, sa


@pytest.mark.parametrize("name", list(RECOMPUTE_CASES))
def test_b4_recompute_tape_equals_k1(host_lib, name):
    """Every slot i of B4's recompute tape holds, bit for bit, the carried
    channels of K1's in-place state after i steps of the same segment, and
    its clock is K1's time after i steps; the segment moves every robot."""
    state, body, stats, ctrl, seg_base, cot, kw = RECOMPUTE_CASES[name]()
    tape = []
    host_backward(host_lib, state, body, stats, ctrl, seg_base, cot, kw, tape_out=tape)
    tape, tape_t = tape
    S = kw["num_steps"]
    assert tape.shape[1] == S + 1 and tape_t.shape[1] == S
    for i in range(S + 1):
        st, sa = (state, stats) if i == 0 else _k1_in_place(
            host_lib, state, body, stats, ctrl, seg_base, dict(kw, num_steps=i))
        assert torch.equal(tape[:, i, :fr._TSAVG], st[:, :fr._TSAVG]), (name, i)
        if i < S:
            assert torch.equal(tape_t[:, i], sa[:, fr._S_TIME]), (name, i)
    assert bool((tape[:, S, fr._POS:fr._SCALE] != state[:, fr._POS:fr._SCALE]).any(2).all())


@pytest.mark.parametrize("name", ["large_angles", "fluid_mesh", "material"])
def test_b4_over_a_cluster_keeps_the_bits(host_lib, name):
    """B4 with each robot's reverse sweep split over a cluster of 2, 3 and 4
    blocks (x-planes a block: 2, 2, 1 at 4^3; the slabs of the blocks
    apart, a bond along x across a block's face reading its far end in the
    next block's slab, a voxel its lower neighbour's in the block below)
    gives the bits of one block a robot."""
    if name == "large_angles":
        args = _case(**CASES[name])
    elif name == "material":
        args = _material_case(20)
    else:
        args = _variant_case("mesh")
    one = host_backward(host_lib, *args)
    assert float(one[1].abs().max()) > 0
    for cluster in (2, 3, 4):
        got = host_backward(host_lib, *args, cluster=cluster)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1]), (name, cluster)


def test_b4_cluster_rule(host_lib):
    """The x-planes a block of B4's cluster owns (`b4_planes`; the launch
    takes ceil(X / planes) blocks a robot), on a card of 132 multiprocessors
    in groups of 18, 18 and six of 16 that holds a block on each, so that
    it holds sum(floor(g / C)) clusters of C blocks at once: the SQP solve's
    8 robots at 10^3 take clusters of 5 blocks of 2 planes, 11^3 and 12^3 of
    6, 13^3 of 7; at 10^3 17 robots still take 5 blocks, 25 take 4 of 3
    planes and 33 take 3 of 4 (the largest cluster of which all fit at
    once, so the launch is one wave), 66 take 2 blocks of 5 planes; a batch
    that no cluster shape holds at once, a card that holds no cluster, a
    body whose 3 V bond items one block takes at once, or a launch asking
    for one block keeps a robot to one block; a launch asking for 4 blocks
    at 10^3 gets 4 of 3 planes (the last 1), whatever the card holds."""
    f = host_lib.emu_b4_planes
    f.argtypes = [_I] * 6 + [_P]
    groups = (18, 18) + (16,) * 6
    card = (ctypes.c_int * 9)(*[0] + [sum(g // c for g in groups) for c in range(1, 9)])
    none = (ctypes.c_int * 9)(*[0, 132] + [0] * 7)
    assert [f(8, n, n, n, 512, 0, card) for n in (10, 11, 12, 13)] == [2, 2, 2, 2]
    assert [f(B, 10, 10, 10, 512, 0, card) for B in (17, 25, 33, 66, 67, 133, 1024)] \
        == [2, 3, 4, 5, 10, 10, 10]
    assert f(8, 10, 10, 10, 512, 0, none) == 10
    assert f(8, 5, 5, 4, 512, 0, card) == 5
    assert f(8, 10, 10, 10, 512, 1, card) == 10
    assert f(8, 10, 10, 10, 512, 4, none) == 3
