"""K1's and B4's material instances in water and with growth, checked
without a card.

`tests/cuda_host/emulate.cpp` built by g++ with `EMU_MAT_VARIANTS` (its
material entry points then run the variant the flags select; at -O0, which
halves the build of the added instances and changes no result: the host
has no contraction into FMA and no x87 arithmetic at either level) runs
`k1_steps` with MAT in the voxel-face drag, facet drag and development
variants, and B4's `reverse_segment<VARIANT, true>`. As
tests/test_torch_k1_host.py and tests/test_torch_b4_host.py hold the land
material instance:

- K1 against `fused_rollout_plain` over 25 steps, every carried channel
  group within 1e-4 of its largest plain value (the rotational groups
  within 2e-3, plasticity's strain offset within 1e-4; g++'s libm is not
  torch's), on materials_palette with plasticity and the clamp, without
  and with volume effects, with the features; each case with its guard:
  the facet drag's corners on the linear fixed point's per-side strains,
  or the nonlinear stress off, far outside;
- the compact pass equal to the dense one, bit for bit, on a design
  squeezed into contact;
- the tape form (B4's recompute) equal to the in-place loop, bit for bit;
- B4 against autograd through the plain version within 2e-4 of each
  group's largest value, with bonds past yield and clamped voxels; the
  variant's and the material instance's defects, and a launch one step
  short, far outside; its recompute's last slot equal to K1's in-place
  material step.
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_b4_host import (
    REL_TOL,
    _launch_args,
    _worst,
    branch_counts,
    emulation_library,
    host_backward,
    material_guards,
)
from test_torch_k1_host import _host_any, _mat_worst, _squeezed, _stirred

from evosoro_tpu_torch import bench
from evosoro_tpu_torch.core.rollout import init_state
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)
MODELS = ("face", "mesh", "devo")
_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def mv_lib():
    """The kernels' sources built for the host with the material instances
    of every variant."""
    lib = emulation_library("-DEMU_MAT_VARIANTS", opt="-O0")
    lib.emu_bwd.argtypes = [_P, _P, _I, _P, _P] + [_I] * 8 + [_P, _I, _P, _P, _P, _P, _P, _I]
    return lib


def _opts(model):
    return dict(fluid=model) if model != "devo" else dict(devo=True)


def _workload(model, vol=False, contact=None, feat=False):
    """Two robots of the bench design (3^3, in its 4^3 shell in water; 4^3
    with growth) on materials_palette with plasticity and the clamp at
    `bench.MATERIALS_MAX_VEL`, stirred (and squeezed into contact with a
    pair table)."""
    args, kw, _ = bench.packed_workload(2, n=4 if model == "devo" else 3,
                                        collision=contact is not None,
                                        compact=contact == "compact", device="cpu",
                                        materials=True, volume=vol, **_opts(model))
    kw = dict(kw, scalars=dict(kw["scalars"], max_vel_limit=bench.MATERIALS_MAX_VEL))
    if feat:
        kw = bench.with_features(kw, args[2], n_win=4, n_src=1)
    if contact:
        args = _squeezed(args)
    return _stirred(args), kw


def _linear_sides():
    """The plain version's facet drag on the linear fixed point's per-side
    strains, the stress kept."""
    from evosoro_tpu_torch.core import step as step_mod

    nonlinear = step_mod._nonlinear_stress

    def linear(d, strain, b):
        stress, _, _ = nonlinear(d, strain, b)
        e1, e2 = b.bond_e1[..., d, :, :, :], b.bond_e2[..., d, :, :, :]
        s_sum = e1 + e2
        hom = b.bond_homogeneous[..., d, :, :, :] | (torch.abs(e1 - e2)
                                                     <= 0.0005 * torch.abs(s_sum))
        return (stress, torch.where(hom, strain, 2.0 * step_mod._safe_div(e2, s_sum) * strain),
                torch.where(hom, strain, 2.0 * step_mod._safe_div(e1, s_sum) * strain))

    return step_mod, "_nonlinear_stress", linear


def _sides_linear_slope():
    """The plain version's per-side strains with the linear fixed point's
    derivative in place of the stress equalization's, their values kept:
    the facet drag's corner cotangent pulled back as if the bond were
    linear."""
    module, attr, linear = _linear_sides()
    nonlinear = getattr(module, attr)

    def linear_slope(d, strain, b):
        stress, sv1, sv2 = nonlinear(d, strain, b)
        _, l1, l2 = linear(d, strain, b)
        return stress, sv1.detach() + l1 - l1.detach(), sv2.detach() + l2 - l2.detach()

    return module, attr, linear_slope


@pytest.mark.parametrize("vol", [False, True], ids=["materials", "volume"])
@pytest.mark.parametrize("model", MODELS)
def test_host_compiled_material_variants_match_plain(mv_lib, model, vol):
    """K1's material (and volume) instance of each variant, with the
    features, against the plain version over 25 steps; the guard lands far
    outside: with the facet drag the corners on the linear fixed point's
    per-side strains (without volume effects), else the
    nonlinear stress off (the volume bit off under volume effects)."""
    from unittest import mock

    args, kw = _workload(model, vol=vol, feat=True)
    if model == "mesh":
        # drag 10^4 times the experiments', so that the corners' strains weigh
        stats = args[2].clone()
        stats[:, fr._S_DRAGC] = 1.5e7
        args = (args[0], args[1], stats, args[3])
    steps = 25
    out_h, st_h = _host_any(mv_lib, args, kw, steps)
    (out_p, st_p), yielded, clamped = branch_counts(
        lambda: fr.fused_rollout_plain(*args, num_steps=steps, **kw))
    assert clamped > 0 and (vol or yielded > 0), (yielded, clamped)
    assert _mat_worst(out_h, out_p) <= REL_TOL
    if vol:
        d = (out_h[:, fr._TSAVG:fr._SOFF] - out_p[:, fr._TSAVG:fr._SOFF]).abs().max()
        assert float(d) <= 1e-4 * float(out_p[:, fr._TSAVG:fr._SOFF].abs().max())
        torch.testing.assert_close(st_h[:, fr._S_DT], st_p[:, fr._S_DT], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(st_h[:, fr._S_TIME], st_p[:, fr._S_TIME], rtol=1e-6, atol=0.0)
    if model == "mesh" and not vol:
        module, attr, fn = _linear_sides()
        with mock.patch.object(module, attr, fn):
            wrong, _ = fr.fused_rollout_plain(*args, num_steps=steps, **kw)
    else:
        off = dict(volume=False) if vol else dict(nonlinear=False, mdl_data=False)
        wrong, _ = fr.fused_rollout_plain(*args, num_steps=steps, **dict(
            kw, flags=dict(kw["flags"], **off), ss_packed=None if not vol else
            kw.get("ss_packed")))
    assert _mat_worst(out_h, wrong) > 20 * REL_TOL


@pytest.mark.parametrize("model", MODELS)
def test_host_compiled_compact_equals_dense_in_each_variant(mv_lib, model):
    """The material instance's compact pass and its dense pass, on the
    design squeezed into contact, give the same bits over 10 steps; the
    pass has work (a launch without contact lands elsewhere)."""
    args_c, kw_c = _workload(model, contact="compact")
    args_d, kw_d = _workload(model, contact="dense")
    assert torch.equal(args_c[0], args_d[0]) and kw_c["flags"]["collision_compact"]
    out_c, st_c = _host_any(mv_lib, args_c, kw_c, 10)
    out_d, st_d = _host_any(mv_lib, args_d, kw_d, 10)
    assert torch.equal(out_c, out_d) and torch.equal(st_c, st_d)
    free = dict(kw_c, flags=dict(kw_c["flags"], collision=False, collision_compact=False))
    out_n, _ = _host_any(mv_lib, args_c[:3] + (None,), free, 10)
    assert not torch.equal(out_n[:, fr._LIN:fr._LIN + 3], out_c[:, fr._LIN:fr._LIN + 3])


@pytest.mark.parametrize("model", MODELS)
def test_host_compiled_tape_form_equals_in_place(mv_lib, model):
    """The step loop's tape form (B4's recompute) and the in-place loop give
    the same bits over 25 steps, with volume effects and the dense pass."""
    args, kw = _workload(model, vol=True, contact="dense")
    runs = []
    B, steps = args[0].shape[0], 25
    clock, taken = torch.zeros((B, steps)), torch.zeros(B, dtype=torch.int32)
    mv_lib.emu_tape_clock.argtypes = [_P, _P, _I]
    try:
        for mode in (0, 1):
            mv_lib.emu_set_step(mode)
            runs.append(_host_any(mv_lib, args, kw, steps))
            if mode == 0:
                assert mv_lib.emu_tape_clock(clock.data_ptr(), taken.data_ptr(), steps) == B
    finally:
        mv_lib.emu_set_step(1)
    assert bool((runs[0][0] != args[0]).any(2)[:, fr._POS:fr._SCALE].all())
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def _bwd_case(model, pre=20, B=2, S=6, K=3, total=48):
    """(state, body, stats, ctrl, seg_base, cot, kw) of one backward launch
    of `bench.sqp_workload(materials=True, ...)` at 3^3 (4^3 with the facet
    drag's shell; growth's 5x5x4), `pre` steps into a rollout under random
    controls; in water at a drag of 1.5e5 with the momenta perturbed, so
    that the drag weighs in the adjoint; with growth under clamp bounds of
    0.9995 L and 1.0005 L."""
    rng = np.random.default_rng(4)
    body, sim, env, dt = bench.sqp_workload(n=3, device="cpu", materials=True, **_opts(model))
    kw = dict(num_steps=S, grid_shape=tuple(body.occ.shape),
              scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=fr.launch_flags(body, sim, env, collision=False, segmented=True),
              n_knots=K, total_steps=total)
    V = body.occ.numel()
    state = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
    bp = fr.pack_body(body)
    stats = fr.make_stats(body, B, dt, sim, env)
    ctrl = torch.as_tensor(rng.uniform(-0.1, 0.1, size=(B, K, V)).astype(np.float32))
    state, stats = fr.fused_rollout_plain(state, bp, stats, None, control_packed=ctrl,
                                          seg_base=0, **dict(kw, num_steps=pre))
    state, stats = state.clone(), stats.clone()
    if model != "devo":
        stats[:, fr._S_DRAGC] = 1.5e5
        occ = (bp[:, fr._B_OCC] > 0.5).float()
        kick = torch.as_tensor(rng.standard_normal((B, 3, V)).astype(np.float32))
        state[:, fr._LIN:fr._LIN + 3] += 3 * kick * state[:, fr._LIN:fr._LIN + 3].abs().max() \
            * occ[:, None]
    else:  # clamp bounds that keep the old scale now and then
        stats[:, fr._S_MINTF] = 0.9995
        stats[:, fr._S_GAMP] = 5e-4
    cot = torch.as_tensor(rng.standard_normal((B, fr.C_S, V)).astype(np.float32))
    return state.contiguous(), bp, stats.contiguous(), ctrl, pre, cot, kw


@pytest.mark.parametrize("model", MODELS)
def test_host_compiled_material_adjoint_in_each_variant(mv_lib, model):
    """B4's material instance of each variant against autograd through the
    plain version, with bonds past yield and clamped voxels; the material
    instance's defects (the linear slope, the clamp's factor detached), the
    variant's (the drag's adjoint dropped; with growth the clamps'
    cotangent; with the facet drag also the per-side strains' slope of the
    linear fixed point), and a launch one step short land far outside. The
    recompute's last slot is K1's in-place material step, bit for bit."""
    from unittest import mock

    from test_torch_b4_host import _k1_in_place

    from evosoro_tpu_torch.core import step as step_mod
    from evosoro_tpu_torch.envs import drag as drag_mod

    state, body, stats, ctrl, seg_base, cot, kw = _bwd_case(model)
    assert kw["flags"]["nonlinear"] and kw["flags"]["max_vel"]
    tape = []
    got = host_backward(mv_lib, state, body, stats, ctrl, seg_base, cot, kw, tape_out=tape)
    ref, yielded, clamped = branch_counts(
        lambda: fr.fused_bwd_plain(state, body, stats, ctrl, seg_base, cot, **kw))
    assert yielded > 0 and clamped > 0, (yielded, clamped)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert bool((got[0][:, fr._TSAVG:] == 0).all())
    assert _worst(got, ref) <= REL_TOL
    if model == "devo":
        scale_update = step_mod._scale_update
        variant = [(step_mod, "_scale_update",
                    lambda *a: (scale_update(*a)[0].detach(), scale_update(*a)[1]))]
    elif model == "face":
        face = step_mod._fluid_drag
        variant = [(step_mod, "_fluid_drag", lambda *a: face(*a).detach())]
    else:
        mesh = drag_mod.mesh_drag_forces
        variant = [(drag_mod, "mesh_drag_forces", lambda *a, **k: mesh(*a, **k).detach()),
                   _sides_linear_slope()]
    for module, attr, fn in [g[1:] for g in material_guards()] + variant:
        with mock.patch.object(module, attr, fn):
            wrong = fr.fused_bwd_plain(state, body, stats, ctrl, seg_base, cot, **kw)
        assert _worst(got, wrong) > 20 * REL_TOL, attr
    short = host_backward(mv_lib, state, body, stats, ctrl, seg_base, cot,
                          dict(kw, num_steps=kw["num_steps"] - 1))
    assert _worst(short, ref) > 100 * REL_TOL
    end, _ = _k1_in_place(mv_lib, state, body, stats, ctrl, seg_base, kw)
    S = kw["num_steps"]
    assert torch.equal(tape[0][:, S, :fr._TSAVG], end[:, :fr._TSAVG])
    B, X, Y, Z, bits, _, _ = _launch_args(state, body, kw)
    assert bits & fr._K1_FLAG_BITS["nonlinear"] and fr._flag_bits(kw["flags"]) == bits
