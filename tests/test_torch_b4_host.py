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
import subprocess

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


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernels' sources built for the host into a shared library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' sources for the host")
    out = tmp_path_factory.mktemp("cuda_host") / "libemulate.so"
    cmd = [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-x", "c++", "-shared",
           "-fPIC", "-DEVOSORO_HOST_EMULATION", "-I", os.path.join(HERE, "cuda_host"),
           "-I", str(build.CSRC), "-o", str(out),
           os.path.join(HERE, "cuda_host", "emulate.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(out))
    lib.emu_fwd.argtypes = [_P, _P, _I, _P, _P] + [_I] * 8 + [_P, _I]
    lib.emu_bwd.argtypes = [_P, _P, _I, _P, _P] + [_I] * 8 + [_P, _I, _P, _P, _P, _P]
    return lib


def _launch_args(state, body, kw):
    X, Y, Z = kw["grid_shape"]
    B = state.shape[0]
    bits = sum(b for k, b in fr._K1_FLAG_BITS.items() if kw["flags"].get(k))
    params = fr._k1_params(kw["scalars"], fr.DEFAULT_PRECISION)
    return B, X, Y, Z, bits, params, int(body.shape[0] == B and B > 1)


def host_forward(lib, state, body, stats, ctrl, seg_base, kw):
    B, X, Y, Z, bits, params, batched = _launch_args(state, body, kw)
    st, sa = state.clone(), stats.clone()
    lib.emu_fwd(st.data_ptr(), body.data_ptr(), batched, sa.data_ptr(), ctrl.data_ptr(),
                kw["n_knots"], kw["total_steps"], seg_base, B, X, Y, Z,
                kw["num_steps"], params.ctypes.data, bits)
    return st, sa


def host_backward(lib, state, body, stats, ctrl, seg_base, cot, kw):
    B, X, Y, Z, bits, params, batched = _launch_args(state, body, kw)
    S, V = kw["num_steps"], X * Y * Z
    tape = torch.empty((B, S + 1, fr._B4_TAPE_CHANNELS, V))
    tape_t = torch.empty((B, S))
    cs, cu = cot.clone(), torch.zeros_like(ctrl)
    lib.emu_bwd(state.data_ptr(), body.data_ptr(), batched, stats.data_ptr(),
                ctrl.data_ptr(), kw["n_knots"], kw["total_steps"], seg_base, B, X, Y, Z,
                S, params.ctypes.data, bits, tape.data_ptr(), tape_t.data_ptr(),
                cs.data_ptr(), cu.data_ptr())
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
