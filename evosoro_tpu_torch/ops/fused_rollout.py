"""Fused multi-step rollout: host side, plain versions and kernel wrappers.

The port of `evosoro_tpu/ops/fused_rollout.py`. The TPU kernel there
(`_make_kernel`, launched by `_fused_call`) advances B robots for
`num_steps` with the state held on chip; here three CUDA kernels written for
Hopper take its place on the evolution loop's envelope:

- K1 (`fused_call`, `csrc/fused_rollout.cu`): the forward multi-step
  rollout, one block per robot, the step loop inside the kernel, with the
  MPC control-knot channel and the segmented mode (a launch that advances
  `num_steps` of a longer rollout from a global step offset);
- B4 (`fused_bwd_call`, `csrc/fused_rollout_bwd.cu`): the reverse-mode
  segment, the adjoint of K1's step written by hand, which pulls a
  segment's end-state cotangent back to its start state and the control
  knots (the JAX package's `_fused_bwd_call`);
- K2 (`pair_contact_forces`, `csrc/pair_contact.cu`): the dense
  self-contact pass, a device routine of K1 that also has its own launch.

Each wrapper takes its kernel for CUDA tensors and its plain PyTorch
version (`fused_rollout_plain`, `pair_contact_forces_plain`,
`fused_bwd_plain`) for CPU
tensors. There is no fallback: a build failure, a launch failure or a
feature outside the envelope on a CUDA tensor raises.

The packed channel maps `C_S`/`C_B`/`C_STAT` and their offsets are kept
identical to the JAX package so states and stats compare channel by channel.
The port's own layout has no lane padding: V = X*Y*Z voxels, flat x-major.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import numpy as np
import torch

from evosoro_tpu_torch.core.constants import (
    DEFAULT_PRECISION,
    HYSTERESIS_FACTOR,
    REF_PI_FLOAT,
    SA_BOND_EXT_PERC,
    Precision,
)
from evosoro_tpu_torch.core.types import EnvParams, SimParams, SimState, VoxelBody
from evosoro_tpu_torch.ops import build

# ---------------------------------------------------------------------------
# Channel maps (identical to evosoro_tpu/ops/fused_rollout.py:70-185)
# ---------------------------------------------------------------------------

# state channels
_POS = 0  # 0..2
_QUAT = 3  # 3..6 (w,x,y,z)
_LIN = 7  # 7..9
_ANG = 10  # 10..12
_SCALE = 13
_SMALL = 14  # 14..16 per direction
_LP2 = 17  # 17..25  last_pos2[d*3 + c]
_LA1 = 26  # 26..34
_LA2 = 35  # 35..43
_MAXS = 44  # 44..46
_TSAVG = 47  # 47..49 volume-effects carry (not ported)
_CSAVG = 50  # 50..52
_SOFF = 53  # 53..55 plastic strain offset (not ported)
_DEVO_DYN = 56  # ballistic devo fields (not ported)
C_S = 64

# body channels
_B_OCC = 0
_B_MASS = 1
_B_MASS_INV = 2
_B_INERTIA_INV = 3
_B_2SQ_MEXS = 4
_B_2SQ_IEXSSS = 5
_B_LIN_STIFF = 6
_B_US = 7
_B_UD = 8
_B_CTE = 9
_B_PHASE = 10
_B_AMPDAMP = 11
_B_DIR = 12
_B_PER_DIR = 20
_D_MASK = 0
_D_HOM = 1
_D_E1 = 2
_D_E2 = 3
_D_E = 4
_D_A2 = 5
_D_B1 = 6
_D_B2 = 7
_D_B3 = 8
_D_DA1M1 = 9
_D_DA1M2 = 10
_D_DA2I1 = 11
_D_DA2I2 = 12
_D_DB1M1 = 13
_D_DB1M2 = 14
_D_DB2FM1 = 15
_D_DB2FM2 = 16
_D_DB3I1 = 17
_D_DB3I2 = 18
_B_DEVO = _B_DIR + 3 * _B_PER_DIR  # 72
_B_INIT_SIZE = _B_DEVO + 0
_B_FINAL_SIZE = _B_DEVO + 1
_B_GROWTH_T = _B_DEVO + 2
_B_START_GT = _B_DEVO + 3
_B_FINAL_PHASE = _B_DEVO + 4
_B_FINAL_AD = _B_DEVO + 5
_B_EMOD = _B_DEVO + 6
_B_POISSON = _B_DEVO + 7
_B_MTPHASE = _B_DEVO + 8
_B_MATMODEL = _B_DEVO + 9
_B_PLASTIC = _B_DEVO + 10
_B_YIELD = _B_DEVO + 11
_B_MAT = _B_DEVO + 12
C_B = 88

# stats channels
_S_TIME = 0
_S_DIV = 1
_S_DT = 2
_S_INICM = 3  # 3..5
_S_CAPT = 6
_S_INV_MASS = 7
_S_STOP = 8
_S_TAMP = 9
_S_TPER = 10
_S_INITCM = 11
_S_GRAV = 12
_S_MINTF = 13
_S_GAMP = 14
_S_DRAGC = 15
_S_KE = 16  # 16..21
_S_SRC = 22  # 22..28
_S_FELL = 29
_S_PCMY = 30
_S_PVOL = 31
_S_ND = 32
_S_NDRG = 33
_S_NDFZ = 34
_S_NTR = 35
_S_LASTTR = 36
_S_WLAST = 37
_S_WPREV = 38
_S_WCNT = 39
_S_LASTWIN = 40
_S_NEEDLE = 41  # 41..43
_S_NCAP = 44
_S_EOLY = 45
_S_EOLCAP = 46
C_STAT = 48

_PER_DIR_FIELDS = [
    ("bond_mask", _D_MASK), ("bond_homogeneous", _D_HOM),
    ("bond_e1", _D_E1), ("bond_e2", _D_E2), ("bond_e", _D_E),
    ("bond_a2", _D_A2), ("bond_b1", _D_B1), ("bond_b2", _D_B2),
    ("bond_b3", _D_B3),
    ("d_a1m1", _D_DA1M1), ("d_a1m2", _D_DA1M2),
    ("d_a2i1", _D_DA2I1), ("d_a2i2", _D_DA2I2),
    ("d_b1m1", _D_DB1M1), ("d_b1m2", _D_DB1M2),
    ("d_b2fm1", _D_DB2FM1), ("d_b2fm2", _D_DB2FM2),
    ("d_b3i1", _D_DB3I1), ("d_b3i2", _D_DB3I2),
]

# shared floats a voxel K1 needs (csrc/fused_rollout.cu: BF, + staging)
_K1_SMEM_FLOATS = 36
_K1_SMEM_FLOATS_COLL = 43
_SMEM_BYTES = 232448  # a block's shared memory on Hopper


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


def _flat(a, lead):
    """(*lead, X, Y, Z) -> (*lead, V) x-major flatten; controls
    (B, K, X, Y, Z) become (B, K, V). The port's layout has no lane
    padding."""
    return a.reshape(tuple(lead) + (-1,))


def pack_state(state: SimState, dtype=torch.float32):
    """Batched SimState (B, X, Y, Z, ...) -> (B, C_S, V)."""
    B = state.scale.shape[0]
    f = lambda a: _flat(a, (B,)).to(dtype)  # noqa: E731
    zero = torch.zeros((B, state.scale[0].numel()), dtype=dtype,
                       device=state.scale.device)
    chans = [zero] * C_S
    for c in range(3):
        chans[_POS + c] = f(state.pos[..., c])
        chans[_LIN + c] = f(state.linmom[..., c])
        chans[_ANG + c] = f(state.angmom[..., c])
    for c in range(4):
        chans[_QUAT + c] = f(state.quat[..., c])
    chans[_SCALE] = f(state.scale)
    for d in range(3):
        chans[_SMALL + d] = f(state.small_angle[:, d])
        chans[_MAXS + d] = f(state.max_strain[:, d])
        for c in range(3):
            chans[_LP2 + 3 * d + c] = f(state.last_pos2[:, d, ..., c])
            chans[_LA1 + 3 * d + c] = f(state.last_angle1[:, d, ..., c])
            chans[_LA2 + 3 * d + c] = f(state.last_angle2[:, d, ..., c])
    if state.strain_offset is not None:
        for d in range(3):
            chans[_SOFF + d] = f(state.strain_offset[:, d])
    return torch.stack(chans, dim=1).contiguous()


def pack_state_single(state: SimState, dtype=torch.float32):
    """Unbatched SimState -> (C_S, V)."""
    batched = SimState(**{
        f.name: (None if getattr(state, f.name) is None
                 else getattr(state, f.name)[None])
        for f in dataclasses.fields(SimState)})
    return pack_state(batched, dtype)[0]


def unpack_state(packed, template: SimState, grid_shape) -> SimState:
    """(B, C_S, V) -> batched SimState with `template`'s other fields."""
    X, Y, Z = grid_shape
    B = packed.shape[0]
    dtype = template.pos.dtype

    def g(k):
        return packed[:, k, :].reshape(B, X, Y, Z).to(dtype)

    def vec(base, n=3):
        return torch.stack([g(base + c) for c in range(n)], dim=-1)

    scale = g(_SCALE)
    return template.replace(
        pos=vec(_POS), quat=vec(_QUAT, 4), linmom=vec(_LIN), angmom=vec(_ANG),
        scale=scale, last_scale=scale,
        small_angle=torch.stack([g(_SMALL + d) > 0.5 for d in range(3)], dim=1),
        max_strain=torch.stack([g(_MAXS + d) for d in range(3)], dim=1),
        last_pos2=torch.stack([vec(_LP2 + 3 * d) for d in range(3)], dim=1),
        last_angle1=torch.stack([vec(_LA1 + 3 * d) for d in range(3)], dim=1),
        last_angle2=torch.stack([vec(_LA2 + 3 * d) for d in range(3)], dim=1),
    )


def pack_body(body: VoxelBody, dtype=torch.float32):
    """VoxelBody -> (1, C_B, V), or (B, C_B, V) for a batch of bodies."""
    lead = tuple(body.occ.shape[:-3])
    f = lambda a: _flat(a, lead).to(dtype)  # noqa: E731
    dev = body.mass.device
    V = int(np.prod(body.occ.shape[-3:]))
    chans = [torch.zeros(lead + (V,), dtype=dtype, device=dev)] * C_B
    chans[_B_OCC] = f(body.occ)
    chans[_B_MASS] = f(body.mass)
    chans[_B_MASS_INV] = f(body.mass_inv)
    chans[_B_INERTIA_INV] = f(body.inertia_inv)
    chans[_B_2SQ_MEXS] = f(body.two_sq_mexs)
    chans[_B_2SQ_IEXSSS] = f(body.two_sq_iexsss)
    chans[_B_LIN_STIFF] = f(body.lin_stiffness)
    chans[_B_US] = f(body.u_static)
    chans[_B_UD] = f(body.u_dynamic)
    chans[_B_CTE] = f(body.cte)
    chans[_B_PHASE] = f(body.phase_offset)
    chans[_B_AMPDAMP] = f(body.temp_amp_damp)
    for d in range(3):
        base = _B_DIR + d * _B_PER_DIR
        for name, off in _PER_DIR_FIELDS:
            chans[base + off] = f(getattr(body, name)[..., d, :, :, :])
    chans[_B_INIT_SIZE] = f(body.initial_voxel_size)
    chans[_B_FINAL_SIZE] = f(body.final_voxel_size)
    chans[_B_GROWTH_T] = f(body.growth_time)
    chans[_B_START_GT] = f(body.start_growth_time)
    chans[_B_FINAL_PHASE] = f(body.final_phase_offset)
    chans[_B_FINAL_AD] = f(body.final_temp_amp_damp)
    chans[_B_EMOD] = f(body.e_mod)
    chans[_B_POISSON] = f(body.poisson)
    for name, k in (("mat_temp_phase", _B_MTPHASE), ("mat_model_vox", _B_MATMODEL),
                    ("plastic_mod", _B_PLASTIC), ("yield_stress", _B_YIELD)):
        if getattr(body, name) is not None:
            chans[k] = f(getattr(body, name))
    chans[_B_MAT] = f(body.mat)
    out = torch.stack(chans, dim=-2)
    return (out if lead else out[None]).contiguous()


def pack_collision(colsys, grid_shape):
    """CollisionSystem (S-surface tables) -> dense (V, V) float32 numpy
    pair-stiffness table in x-major voxel order. Zeros encode non-surface
    voxels, pad entries, the lattice-nearby exclusion and self-pairs."""
    X, Y, Z = grid_shape
    V = X * Y * Z
    sidx = np.asarray(colsys.surf_idx)
    smask = np.asarray(colsys.surf_mask).astype(bool)
    flat = sidx[:, 0] * (Y * Z) + sidx[:, 1] * Z + sidx[:, 2]
    dense = np.zeros((V, V), np.float32)
    live = np.nonzero(smask)[0]
    fl = flat[live]
    dense[np.ix_(fl, fl)] = np.asarray(colsys.pair_a1)[
        np.ix_(live, live)].astype(np.float32)
    return dense


def make_stats(body: VoxelBody, batch: int, dt, sim: SimParams, env: EnvParams,
               stop_time=None, dtype=torch.float32):
    """Initial (B, C_STAT) stats for fresh rollouts of one design; any
    channel may be overwritten with per-robot values before the call."""
    dev = body.mass.device
    total_mass = body.mass.sum()  # float32, as the JAX host side
    stats = torch.zeros((batch, C_STAT), dtype=dtype, device=dev)
    stats[:, _S_DT] = torch.as_tensor(dt, dtype=dtype)
    stats[:, _S_INV_MASS] = torch.where(
        total_mass > 0, 1.0 / total_mass, 0.0).to(dtype)
    stats[:, _S_LASTTR] = -1.0
    stats[:, _S_LASTWIN] = -1.0
    stats[:, _S_STOP] = float(np.inf) if stop_time is None else float(stop_time)
    # TempAmplitude/TempPeriod are float32 members in the reference
    stats[:, _S_TAMP] = float(np.float32(env.temp_amplitude))
    stats[:, _S_TPER] = float(np.float32(env.temp_period))
    stats[:, _S_INITCM] = float(sim.init_cm_time)
    stats[:, _S_GRAV] = float(env.grav_acc)
    stats[:, _S_MINTF] = float(sim.min_temp_fact)
    stats[:, _S_GAMP] = float(env.growth_amplitude)
    stats[:, _S_DRAGC] = float(env.aggregate_drag_coefficient)
    stats[:, _S_KE:_S_KE + 6] = -1.0
    stats[:, _S_SRC:_S_SRC + 3] = -1.0
    return stats


@dataclasses.dataclass
class FastRolloutStats:
    """Per-rollout outputs of the fused rollout."""

    time: Any  # (B,)
    diverged: Any  # (B,) bool
    ini_cm: Any  # (B, 3)
    cm_captured: Any  # (B,) bool


def stats_to_outputs(stats) -> FastRolloutStats:
    return FastRolloutStats(
        time=stats[:, _S_TIME],
        diverged=stats[:, _S_DIV] > 0.5,
        ini_cm=stats[:, _S_INICM:_S_INICM + 3],
        cm_captured=stats[:, _S_CAPT] > 0.5,
    )


def packed_metrics(out_state, body_packed, out_stats, L):
    """Locomotion fitness straight off the packed outputs: NormFinalDist =
    |ΔCoM_xy|/L (reference: VX_SimGA.cpp:36), 0 for diverged rollouts."""
    mass = body_packed[:, _B_MASS, :]
    inv_m = out_stats[:, _S_INV_MASS:_S_INV_MASS + 1]
    final_cm = torch.cat([
        (out_state[:, _POS + c, :] * mass).sum(1, keepdim=True) * inv_m
        for c in range(3)], dim=1)
    ini_cm = out_stats[:, _S_INICM:_S_INICM + 3]
    delta = final_cm[:, :2] - ini_cm[:, :2]
    dsq = (delta * delta).sum(-1)
    dist = torch.where(dsq > 0, torch.sqrt(torch.where(dsq > 0, dsq, 1.0)), 0.0) / L
    diverged = out_stats[:, _S_DIV] > 0.5
    return dict(
        norm_final_dist=torch.where(diverged, 0.0, dist),
        final_dist_y=delta[:, 1] / L,
        diverged=diverged,
        final_cm=final_cm,
        ini_cm=ini_cm,
        final_time=out_stats[:, _S_TIME],
    )


def locomotion_fitness(state: SimState, body: VoxelBody, outs: FastRolloutStats):
    """NormFinalDist from a fused rollout (reference: VX_SimGA.cpp:36)."""
    from evosoro_tpu_torch.core.rollout import center_of_mass

    cm = center_of_mass(state, body)
    delta = cm[:, :2] - outs.ini_cm[:, :2]
    dsq = (delta * delta).sum(-1)
    dist = torch.where(dsq > 0, torch.sqrt(torch.where(dsq > 0, dsq, 1.0)), 0.0)
    return torch.where(outs.diverged, 0.0, dist / body.nominal_size)


# ---------------------------------------------------------------------------
# Static scalars and feature flags
# ---------------------------------------------------------------------------


def kernel_scalars(L, sim: SimParams, env: EnvParams) -> dict:
    """The design-time float constants of a launch (the JAX package's
    `kernel_scalars`, same keys)."""
    if env.sources is not None:
        raise NotImplementedError("environmental sources are not ported yet")
    return dict(
        L=float(L),
        slow_damping_z=float(sim.slow_damping_z),
        bond_damping_z=float(sim.bond_damping_z),
        col_damping_z=float(sim.col_damping_z),
        dt_frac=float(sim.dt_frac),
        freeze=float(sim.mid_life_freeze_time),
        freeze_middle=0.5 * (float(sim.stop_condition_value)
                             - float(sim.init_cm_time)),
        max_vel_limit=float(sim.max_vox_vel_limit),
        sources=(),
        sc_value=float(sim.stop_condition_value),
        tb=float(env.time_between_traces),
        nexp=float(env.normalization_exponent),
        min_growth_t=float(env.min_growth_time),
        bal_slow=float(env.ballistic_slowdown_fact),
        max_slow=float(env.max_slowdown_permitted),
    )


def kernel_env_flags(sim: SimParams, env: EnvParams) -> dict:
    """The env/sim-derived feature flags (the JAX package's
    `kernel_env_flags`, same keys). Callers add the body-derived entries."""
    return dict(
        gravity=bool(env.gravity_enabled and not env.fluid_environment),
        floor=bool(env.floor_enabled and not env.fluid_environment),
        sticky=bool(env.sticky_floor),
        temp=bool(env.temp_enabled and env.vary_temp_enabled),
        temp_enabled=bool(env.temp_enabled),
        vary_temp=bool(env.vary_temp_enabled),
        volume=bool(sim.volume_effects_enabled),
        fluid=bool(env.fluid_environment),
        equilibrium=bool(sim.equilibrium_mode),
        freeze_on=float(sim.mid_life_freeze_time) > 0.0,
        max_vel=bool(sim.max_velocity_enabled),
        plasticity=bool(sim.plasticity_enabled),
        needle=bool(env.needle_in_haystack),
        falling=bool(env.falling_prohibited),
        ndbv=bool(env.norm_dist_by_vol),
        window=int(env.num_trace_steps_in_window) > 0,
        n_win=int(env.num_trace_steps_in_window),
    )


def body_flags(body: VoxelBody) -> dict:
    """The body-derived flags the JAX host side adds to `kernel_env_flags`."""
    has_bc = bool((body.dof_fixed != 0).any() or (body.external_force != 0).any()
                  or (body.external_disp != 0).any()
                  or (body.external_tdisp != 0).any())
    return dict(
        nonlinear=not bool(body.all_linear),
        mdl_data=body.ss_strain_vox is not None,
        bc=has_bc,
        fluid_mesh=body.mesh_drag is not None,
        use_init_size=bool(body.using_initial_voxel_size),
        use_final_size=bool(body.using_final_voxel_size),
        use_growth_t=bool(body.using_growth_time),
        use_final_phase=bool(body.using_final_phase_offset),
        use_final_ad=bool(body.using_final_temp_amp_damp),
        ballistic=False,
    )


# flags K1 implements, as the bits csrc/fused_rollout.cu reads
_K1_FLAG_BITS = dict(floor=1, sticky=2, gravity=4, temp=8, freeze_on=16,
                     collision=32)
# flags outside the envelope; each must be off
_K1_REFUSED = ("volume", "fluid", "fluid_mesh", "nonlinear", "mdl_data",
               "plasticity", "equilibrium", "max_vel", "bc", "needle",
               "falling", "ndbv", "window", "ballistic", "use_init_size",
               "use_final_size", "use_growth_t", "use_final_phase",
               "use_final_ad", "collision_compact")


def check_envelope(flags: dict, scalars: dict):
    """Raise NotImplementedError for any flag outside K1's envelope (for
    CPU and CUDA tensors alike, before anything runs)."""
    for k in _K1_REFUSED:
        if flags.get(k):
            raise NotImplementedError(f"fused rollout: '{k}' is not ported yet")
    if flags.get("temp_enabled") and not flags.get("temp"):
        raise NotImplementedError("fused rollout: a fixed (non-varying) "
                                  "temperature is not ported yet")
    if scalars.get("sources"):
        raise NotImplementedError("fused rollout: environmental sources are "
                                  "not ported yet")


def supports(body: VoxelBody, sim: SimParams, env: EnvParams) -> bool:
    """True when (body, sim, env) is inside K1's envelope and its shared
    memory holds the body."""
    flags = dict(kernel_env_flags(sim, env), **body_flags(body))
    try:
        check_envelope(flags, {"sources": () if env.sources is None else (1,)})
    except NotImplementedError:
        return False
    if env.floor_limited:
        return False
    V = int(np.prod(body.occ.shape[-3:]))
    per = _K1_SMEM_FLOATS_COLL if sim.self_collisions_enabled else _K1_SMEM_FLOATS
    return per * 4 * V <= _SMEM_BYTES


# ---------------------------------------------------------------------------
# K2: dense pair contact
# ---------------------------------------------------------------------------

# launches of K2's own kernel (K1 runs K2's routine inside its launch; those
# are counted by FUSED_ROLLOUT_CONTACT_LAUNCHES)
PAIR_CONTACT_LAUNCHES = 0


def pair_contact_forces_plain(pos, scale, a1):
    """Plain version of K2: a transliteration of the JAX package's
    `_pair_contact_forces` over a batch. pos (..., 3, V), scale (..., V),
    a1 (..., V, V) or (V, V) -> forces (..., 3, V) on each voxel. Large
    batches are processed in chunks to bound the (V, V) temporaries."""
    lead = pos.shape[:-2]
    V = pos.shape[-1]
    p = pos.reshape(-1, 3, V)
    s = scale.reshape(-1, V)
    tab = a1.reshape(-1, V, V) if a1.dim() > 2 else a1[None]
    out = torch.empty_like(p)
    chunk = max(1, (1 << 25) // max(1, V * V))
    for lo in range(0, p.shape[0], chunk):
        hi = min(lo + chunk, p.shape[0])
        pc = p[lo:hi]
        diff = pc[:, :, None, :] - pc[:, :, :, None]  # [c, i, j] = p_j - p_i
        dist2 = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2]
        inv = torch.rsqrt(torch.clamp(dist2, min=1e-30))
        nom = 0.75 * (s[lo:hi, :, None] + s[lo:hi, None, :])
        tt = nom * inv
        t_ = tab[lo:hi] if tab.shape[0] > 1 else tab
        mag = torch.where(tt > 1.0, t_ * (tt - 1.0), 0.0)
        out[lo:hi] = -(mag[:, None] * diff).sum(-1)
    return out.reshape(lead + (3, V))


def pair_contact_forces(pos, scale, a1):
    """K2 wrapper. pos (B, 3, V), scale (B, V), a1 (B or 1, V, V), float32
    and contiguous -> forces (B, 3, V). CUDA tensors launch the kernel;
    CPU tensors run `pair_contact_forces_plain`."""
    if pos.dim() != 3 or pos.shape[1] != 3:
        raise ValueError(f"pos must be (B, 3, V), got {tuple(pos.shape)}")
    B, _, V = pos.shape
    if tuple(scale.shape) != (B, V):
        raise ValueError(f"scale must be (B, V) = {(B, V)}, got {tuple(scale.shape)}")
    if a1.dim() != 3 or a1.shape[0] not in (1, B) or tuple(a1.shape[1:]) != (V, V):
        raise ValueError(f"a1 must be (B or 1, V, V), got {tuple(a1.shape)}")
    for name, t in (("pos", pos), ("scale", scale), ("a1", a1)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")
    if pos.device.type == "cpu":
        return pair_contact_forces_plain(pos, scale, a1)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    for name, t in (("pos", pos), ("scale", scale), ("a1", a1)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if 16 * V > _SMEM_BYTES:
        raise ValueError(f"V={V} voxels overflow K2's shared memory")
    out = torch.empty_like(pos)
    fn = build.library("pair_contact")
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(pos.data_ptr(), scale.data_ptr(), a1.data_ptr(), out.data_ptr(),
                B, V, int(a1.shape[0] == B and B > 1), stream)
    build.check(rc, "pair_contact_forces")
    global PAIR_CONTACT_LAUNCHES
    PAIR_CONTACT_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# K1: fused forward rollout
# ---------------------------------------------------------------------------

FUSED_ROLLOUT_LAUNCHES = 0
# K1 launches that ran the contact pass (K2's device routine) in their steps
FUSED_ROLLOUT_CONTACT_LAUNCHES = 0
# K1 launches that ran the control-knot channel or the segmented mode
FUSED_ROLLOUT_KNOT_LAUNCHES = 0


def _k1_params(scalars: dict, prec: Precision) -> np.ndarray:
    """K1's float32 constants, each the float32 rounding of the double the
    plain version's Python expression gives (csrc/fused_rollout.cu Params)."""
    L = np.float32(scalars["L"])
    vals = [
        L,
        L * L,  # float32 product, as torch's L * L on a float32 scalar
        -scalars["slow_damping_z"],
        10.0 * scalars["slow_damping_z"],
        0.5 * scalars["bond_damping_z"],
        0.5 * (0.5 * scalars["bond_damping_z"]),
        scalars["col_damping_z"],
        prec.small_angle_w,
        prec.smallish_angle_w,
        prec.sa_bond_bend_rad,
        HYSTERESIS_FACTOR * prec.sa_bond_bend_rad,
        SA_BOND_EXT_PERC,
        HYSTERESIS_FACTOR * SA_BOND_EXT_PERC,
        prec.sl_thresh_acos2sqrt,
        prec.small_angle_rad,
        np.pi - prec.discard_angle_rad,
        0.0005,
        scalars["sc_value"],
        0.5 * scalars["freeze"],
        2.0 * REF_PI_FLOAT,
    ]
    return np.asarray(vals, dtype=np.float32)


def _unpack_body(body_packed, grid_shape, L) -> VoxelBody:
    """The VoxelBody fields the eager step reads, from packed channels
    (shared bodies come back unbatched)."""
    X, Y, Z = grid_shape
    bp = body_packed[0] if body_packed.shape[0] == 1 else body_packed
    lead = tuple(bp.shape[:-2])
    dev, dt = bp.device, bp.dtype

    def g(k):
        return bp[..., k, :].reshape(lead + (X, Y, Z))

    def per_dir(off, cast=None):
        a = torch.stack([g(_B_DIR + d * _B_PER_DIR + off) for d in range(3)], dim=-4)
        return a > 0.5 if cast is bool else a

    ix, iy, iz = torch.meshgrid(torch.arange(X, device=dev), torch.arange(Y, device=dev),
                                torch.arange(Z, device=dev), indexing="ij")
    Lt = torch.tensor(L, dtype=dt, device=dev)
    nom_pos = (torch.stack([ix, iy, iz], dim=-1).to(dt) + 0.5) * Lt
    inertia_inv = g(_B_INERTIA_INV)
    zeros = torch.zeros(lead + (X, Y, Z), dtype=dt, device=dev)
    kw = {name: per_dir(off, bool if name in ("bond_mask", "bond_homogeneous") else None)
          for name, off in _PER_DIR_FIELDS}
    return VoxelBody(
        occ=g(_B_OCC) > 0.5, mat=g(_B_MAT).to(torch.int32), nom_pos=nom_pos,
        nominal_size=float(L), mass=g(_B_MASS), mass_inv=g(_B_MASS_INV),
        inertia=torch.where(inertia_inv != 0, 1.0 / torch.where(
            inertia_inv != 0, inertia_inv, 1.0), 0.0),
        inertia_inv=inertia_inv, first_moment=zeros, e_mod=g(_B_EMOD),
        poisson=g(_B_POISSON), cte=g(_B_CTE), u_static=g(_B_US),
        u_dynamic=g(_B_UD), lin_stiffness=g(_B_LIN_STIFF),
        two_sq_mexs=g(_B_2SQ_MEXS), two_sq_iexsss=g(_B_2SQ_IEXSSS),
        phase_offset=g(_B_PHASE), final_phase_offset=zeros,
        temp_amp_damp=g(_B_AMPDAMP), final_temp_amp_damp=zeros,
        initial_voxel_size=zeros, final_voxel_size=zeros, growth_time=zeros,
        start_growth_time=zeros,
        dof_fixed=torch.zeros(lead + (X, Y, Z), dtype=torch.int32, device=dev),
        external_force=zeros[..., None].expand(lead + (X, Y, Z, 3)),
        external_disp=zeros[..., None].expand(lead + (X, Y, Z, 3)),
        external_tdisp=zeros[..., None].expand(lead + (X, Y, Z, 3)),
        bond_e=kw["bond_e"], bond_a1=kw["bond_e"] * Lt, **{
            k: v for k, v in kw.items() if k != "bond_e"},
    )


def _knot_clock(flags, num_steps, n_knots, control_packed, seg_base, total_steps):
    """(first global step, steps of the knot clock) of a launch, after
    checking that the knot and segment arguments agree."""
    if bool(n_knots) != (control_packed is not None):
        raise ValueError("n_knots and the controls disagree")
    segmented = bool(flags.get("segmented"))
    if segmented != (seg_base is not None):
        raise ValueError("flags['segmented'] and seg_base disagree")
    if segmented and total_steps is None:
        raise ValueError("the segmented mode needs total_steps")
    knot_steps = int(total_steps if total_steps is not None else num_steps)
    if n_knots and knot_steps <= 0:
        raise ValueError("the knot clock needs a positive step count")
    return (int(seg_base) if segmented else 0), knot_steps


def fused_rollout_plain(state_packed, body_packed, stats, collision_packed=None,
                        *, control_packed=None, seg_base=None, num_steps,
                        grid_shape, scalars, flags, n_knots: int = 0,
                        total_steps=None, prec: Precision = DEFAULT_PRECISION):
    """Plain version of K1 on the same packed tensors: unpack, loop the
    eager `core.step.sim_step`, keep the stats row's bookkeeping as the
    kernel does (IniCM capture with the seed at global step 0, divergence
    latch, stop-time freeze), select each step's control knot by the global
    step, and repack. Returns (state_out, stats_out)."""
    from evosoro_tpu_torch.core.step import freeze_where, sim_step

    check_envelope(flags, scalars)
    seg0, knot_steps = _knot_clock(flags, num_steps, n_knots, control_packed,
                                   seg_base, total_steps)
    X, Y, Z = grid_shape
    B = state_packed.shape[0]
    L = scalars["L"]
    body = _unpack_body(body_packed, grid_shape, L)
    if collision_packed is not None:
        body = body.replace(collision=collision_packed[0]
                            if collision_packed.shape[0] == 1 else collision_packed)
    # unpack_state fills every packed field; the rest of the template is the
    # zero plastic offset (plasticity is outside the envelope) and the dtype
    zero = torch.zeros((B, 3, X, Y, Z), dtype=state_packed.dtype,
                       device=state_packed.device)
    template = SimState(**{f.name: None for f in dataclasses.fields(SimState)})
    template = template.replace(pos=zero, strain_offset=zero)
    state = unpack_state(state_packed, template, grid_shape)

    st = stats
    t = st[:, _S_TIME].clone()
    div = st[:, _S_DIV] > 0.5
    dt = st[:, _S_DT]
    ini = st[:, _S_INICM:_S_INICM + 3].clone()
    capt = st[:, _S_CAPT] > 0.5
    inv_m = st[:, _S_INV_MASS]
    stop_t = st[:, _S_STOP]
    init_cm = st[:, _S_INITCM]
    state = state.replace(
        time=t, diverged=div,
        ke_history=torch.full((B, 6), -1.0, dtype=t.dtype, device=t.device))

    sim = SimParams(
        bond_damping_z=scalars["bond_damping_z"],
        col_damping_z=scalars["col_damping_z"],
        slow_damping_z=scalars["slow_damping_z"],
        stop_condition_value=scalars["sc_value"],
        init_cm_time=init_cm,
        min_temp_fact=st[:, _S_MINTF],
        mid_life_freeze_time=scalars["freeze"],
        self_collisions_enabled=bool(flags.get("collision")),
    )
    env = EnvParams(
        grav_acc=st[:, _S_GRAV], temp_amplitude=st[:, _S_TAMP],
        temp_period=st[:, _S_TPER], growth_amplitude=st[:, _S_GAMP],
        gravity_enabled=bool(flags.get("gravity")),
        floor_enabled=bool(flags.get("floor")),
        sticky_floor=bool(flags.get("sticky")),
        temp_enabled=bool(flags.get("temp")),
    )
    mass = body.mass
    for i in range(num_steps):
        i_glob = seg0 + i
        cm = (state.pos * mass[..., None]).flatten(-4, -2).sum(-2) * inv_m[:, None]
        capture = ~capt & (state.time > init_cm)
        take = capture | ((i_glob == 0) & ~capt)
        ini = torch.where(take[:, None], cm, ini)
        capt = capt | capture
        frozen = state.diverged | (state.time >= stop_t)
        ctrl = None
        if n_knots:
            knot = min(i_glob * n_knots // knot_steps, n_knots - 1)
            ctrl = control_packed[:, knot].reshape(B, X, Y, Z)
        new = sim_step(state, body, sim, env, dt, prec, control_offset=ctrl)
        state = freeze_where(frozen, state, new)

    out_state = pack_state(state, state_packed.dtype)
    out_stats = stats.clone()
    out_stats[:, _S_TIME] = state.time
    out_stats[:, _S_DIV] = state.diverged.to(stats.dtype)
    out_stats[:, _S_INICM:_S_INICM + 3] = ini
    out_stats[:, _S_CAPT] = capt.to(stats.dtype)
    # channels the kernel never writes keep their input values
    out_state[:, _TSAVG:] = state_packed[:, _TSAVG:]
    return out_state, out_stats


def fused_call(state_packed, body_packed, stats, collision_packed=None, *,
               control_packed=None, seg_base=None, num_steps: int, grid_shape,
               scalars: dict, flags: dict, n_knots: int = 0, total_steps=None,
               prec: Precision = DEFAULT_PRECISION):
    """K1 wrapper, the counterpart of the JAX package's `_fused_call`.

    state (B, C_S, V), body (B or 1, C_B, V), stats (B, C_STAT), the
    optional pair table (B or 1, V, V) and the optional controls
    (B, n_knots, V), all float32 on one device. Step i of the launch is the
    global step `seg_base + i` (`seg_base` an int, given exactly when
    flags["segmented"] is set); its knot is
    `min(global step * n_knots // knot_steps, n_knots - 1)` with
    `knot_steps = total_steps or num_steps`. Returns (state_out, stats_out).
    CUDA tensors launch K1; CPU tensors run `fused_rollout_plain`. Flags
    outside the envelope raise first.
    """
    check_envelope(flags, scalars)
    seg0, knot_steps = _knot_clock(flags, num_steps, n_knots, control_packed,
                                   seg_base, total_steps)
    X, Y, Z = grid_shape
    V = X * Y * Z
    B = state_packed.shape[0]
    coll = bool(flags.get("collision"))
    if coll != (collision_packed is not None):
        raise ValueError("flags['collision'] and the pair table disagree")
    shapes = [("state", state_packed, (B, C_S, V)), ("stats", stats, (B, C_STAT))]
    if tuple(body_packed.shape[1:]) != (C_B, V) or body_packed.shape[0] not in (1, B):
        raise ValueError(f"body must be (B or 1, {C_B}, {V}), got {tuple(body_packed.shape)}")
    if coll and (collision_packed.dim() != 3 or collision_packed.shape[0] not in (1, B)
                 or tuple(collision_packed.shape[1:]) != (V, V)):
        raise ValueError(f"pair table must be (B or 1, {V}, {V}), got "
                         f"{tuple(collision_packed.shape)}")
    if n_knots:
        shapes.append(("controls", control_packed, (B, int(n_knots), V)))
    for name, t, shp in shapes:
        if tuple(t.shape) != shp:
            raise ValueError(f"{name} must be {shp}, got {tuple(t.shape)}")
    tensors = [("state", state_packed), ("body", body_packed), ("stats", stats)]
    if coll:
        tensors.append(("pair table", collision_packed))
    if n_knots:
        tensors.append(("controls", control_packed))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != state_packed.device:
            raise ValueError(f"{name} is on {t.device}, state on {state_packed.device}")
    if state_packed.device.type == "cpu":
        return fused_rollout_plain(
            state_packed, body_packed, stats, collision_packed,
            control_packed=control_packed, seg_base=seg_base,
            num_steps=num_steps, grid_shape=grid_shape, scalars=scalars,
            flags=flags, n_knots=n_knots, total_steps=total_steps, prec=prec)
    if state_packed.device.type != "cuda":
        raise ValueError(f"unsupported device {state_packed.device}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    per = _K1_SMEM_FLOATS_COLL if coll else _K1_SMEM_FLOATS
    if per * 4 * V > _SMEM_BYTES:
        raise ValueError(f"V={V} voxels overflow K1's shared memory "
                         f"({per * 4 * V} > {_SMEM_BYTES} bytes)")
    bits = sum(b for k, b in _K1_FLAG_BITS.items() if flags.get(k))
    params = _k1_params(scalars, prec)
    state_out = state_packed.clone()
    stats_out = stats.clone()
    fn = build.library("fused_rollout")
    with torch.cuda.device(state_packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(state_out.data_ptr(), body_packed.data_ptr(),
                int(body_packed.shape[0] == B and B > 1), stats_out.data_ptr(),
                collision_packed.data_ptr() if coll else None,
                int(coll and collision_packed.shape[0] == B and B > 1),
                control_packed.data_ptr() if n_knots else None, int(n_knots),
                knot_steps, seg0, B, X, Y, Z, int(num_steps),
                params.ctypes.data_as(ctypes.c_void_p), bits, stream)
    build.check(rc, "fused_rollout")
    global FUSED_ROLLOUT_LAUNCHES, FUSED_ROLLOUT_CONTACT_LAUNCHES
    global FUSED_ROLLOUT_KNOT_LAUNCHES
    FUSED_ROLLOUT_LAUNCHES += 1
    if coll:
        FUSED_ROLLOUT_CONTACT_LAUNCHES += 1
    if n_knots or flags.get("segmented"):
        FUSED_ROLLOUT_KNOT_LAUNCHES += 1
    return state_out, stats_out


# ---------------------------------------------------------------------------
# B4: reverse-mode segment
# ---------------------------------------------------------------------------

FUSED_BWD_LAUNCHES = 0

# channels [0, _TSAVG) carry the rollout and its cotangent; B4's tape holds
# them plus one channel of static-friction decisions (csrc: NT)
_B4_TAPE_CHANNELS = _TSAVG + 1
# flags outside the reverse-mode kernel's envelope (the JAX package's
# `_diff_envelope_ok`); the rest of `check_envelope` applies as well
_DIFF_REFUSED = ("volume", "equilibrium", "plasticity", "needle", "falling",
                 "ndbv", "window", "ballistic", "collision", "mdl_data", "bc")


def diff_envelope_ok(flags, scalars) -> bool:
    """True when the reverse-mode segment kernel covers the launch: the MPC
    control envelope, without collision, volume effects, plasticity,
    sources, fitness features, devo or BC regions."""
    f, sc = dict(flags), dict(scalars)
    return (not any(f.get(k) for k in _DIFF_REFUSED)
            and len(sc.get("sources", ())) == 0)


def _check_bwd(flags, scalars, n_knots, seg_base, total_steps):
    check_envelope(flags, scalars)
    if not diff_envelope_ok(flags, scalars):
        raise NotImplementedError(
            "reverse-mode segment: configuration outside the differentiable "
            "envelope (ops.fused_rollout.diff_envelope_ok)")
    if not n_knots:
        raise ValueError("reverse-mode segment: needs control knots (n_knots > 0)")
    if not flags.get("segmented") or seg_base is None or total_steps is None:
        raise ValueError("reverse-mode segment: needs flags['segmented'], "
                         "seg_base and total_steps")


def fused_bwd_plain(state_packed, body_packed, stats, control_packed, seg_base,
                    cot_state, *, num_steps, grid_shape, scalars, flags,
                    n_knots: int, total_steps,
                    prec: Precision = DEFAULT_PRECISION):
    """Plain version of B4: `torch.autograd.grad` of `fused_rollout_plain`
    with respect to the packed start state and the controls, seeded with
    the END state's cotangent. Returns (cot_state_in, cot_ctrl); channels
    `_TSAVG..C_S` of the first are zero."""
    _check_bwd(flags, scalars, n_knots, seg_base, total_steps)
    sp = state_packed.detach().clone().requires_grad_(True)
    cp = control_packed.detach().clone().requires_grad_(True)
    cot = cot_state.detach().clone()
    cot[:, _TSAVG:] = 0.0  # channels the rollout only copies through
    with torch.enable_grad():
        out_state, _ = fused_rollout_plain(
            sp, body_packed, stats, None, control_packed=cp, seg_base=seg_base,
            num_steps=num_steps, grid_shape=grid_shape, scalars=scalars,
            flags=flags, n_knots=n_knots, total_steps=total_steps, prec=prec)
        g_state, g_ctrl = torch.autograd.grad(
            out_state, (sp, cp), grad_outputs=cot, allow_unused=True)
    if g_state is None:
        g_state = torch.zeros_like(sp)
    if g_ctrl is None:
        g_ctrl = torch.zeros_like(cp)
    return g_state, g_ctrl


def fused_bwd_call(state_packed, body_packed, stats, control_packed, seg_base,
                   cot_state, *, num_steps: int, grid_shape, scalars: dict,
                   flags: dict, n_knots: int, total_steps,
                   prec: Precision = DEFAULT_PRECISION):
    """B4 wrapper, the counterpart of the JAX package's `_fused_bwd_call`:
    pull `cot_state`, the cotangent of a segment's END state, back through
    the `num_steps` steps that `fused_call(seg_base=, total_steps=)` takes
    from `state_packed`.

    state and cot_state (B, C_S, V), body (B or 1, C_B, V), stats
    (B, C_STAT), controls (B, n_knots, V), all float32 on one device.
    Returns (cot_state_in (B, C_S, V), channels `_TSAVG..C_S` zero;
    cot_ctrl (B, n_knots, V)). CUDA tensors launch B4; CPU tensors run
    `fused_bwd_plain`. Flags outside `diff_envelope_ok` raise first."""
    _check_bwd(flags, scalars, n_knots, seg_base, total_steps)
    seg0, knot_steps = _knot_clock(flags, num_steps, n_knots, control_packed,
                                   seg_base, total_steps)
    X, Y, Z = grid_shape
    V = X * Y * Z
    B = state_packed.shape[0]
    if tuple(body_packed.shape[1:]) != (C_B, V) or body_packed.shape[0] not in (1, B):
        raise ValueError(f"body must be (B or 1, {C_B}, {V}), got {tuple(body_packed.shape)}")
    tensors = [("state", state_packed, (B, C_S, V)), ("body", body_packed, None),
               ("stats", stats, (B, C_STAT)),
               ("controls", control_packed, (B, int(n_knots), V)),
               ("cot_state", cot_state, (B, C_S, V))]
    for name, t, shp in tensors:
        if shp is not None and tuple(t.shape) != shp:
            raise ValueError(f"{name} must be {shp}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != state_packed.device:
            raise ValueError(f"{name} is on {t.device}, state on {state_packed.device}")
    kw = dict(num_steps=num_steps, grid_shape=grid_shape, scalars=scalars,
              flags=flags, n_knots=n_knots, total_steps=total_steps, prec=prec)
    if state_packed.device.type == "cpu":
        return fused_bwd_plain(state_packed, body_packed, stats, control_packed,
                               seg_base, cot_state, **kw)
    if state_packed.device.type != "cuda":
        raise ValueError(f"unsupported device {state_packed.device}")
    for name, t, _ in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if _K1_SMEM_FLOATS * 4 * V > _SMEM_BYTES:
        raise ValueError(f"V={V} voxels overflow B4's shared memory "
                         f"({_K1_SMEM_FLOATS * 4 * V} > {_SMEM_BYTES} bytes)")
    bits = sum(b for k, b in _K1_FLAG_BITS.items() if flags.get(k))
    params = _k1_params(scalars, prec)
    S = int(num_steps)
    dev = state_packed.device
    # scratch of the launch: the forward recompute's tape and step clocks
    tape = torch.empty((B, S + 1, _B4_TAPE_CHANNELS, V), dtype=torch.float32, device=dev)
    tape_t = torch.empty((B, max(S, 1)), dtype=torch.float32, device=dev)
    cot = cot_state.clone()  # pulled back in place
    cot_ctrl = torch.zeros_like(control_packed)
    fn = build.library("fused_rollout_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(state_packed.data_ptr(), body_packed.data_ptr(),
                int(body_packed.shape[0] == B and B > 1), stats.data_ptr(),
                control_packed.data_ptr(), int(n_knots), knot_steps, seg0,
                B, X, Y, Z, S, params.ctypes.data_as(ctypes.c_void_p), bits,
                tape.data_ptr(), tape_t.data_ptr(), cot.data_ptr(),
                cot_ctrl.data_ptr(), stream)
    build.check(rc, "fused_rollout_bwd")
    global FUSED_BWD_LAUNCHES
    FUSED_BWD_LAUNCHES += 1
    return cot, cot_ctrl


def fused_rollout(state: SimState, body: VoxelBody, sim: SimParams,
                  env: EnvParams, num_steps: int, dt, stop_time=None,
                  prec: Precision = DEFAULT_PRECISION, stats=None,
                  control_sequence=None):
    """Advance a batched SimState by `num_steps` through `fused_call` for one
    shared design; `control_sequence` is the optional (B, K, X, Y, Z) MPC
    knot channel. Returns (new_state, FastRolloutStats)."""
    if not supports(body, sim, env):
        raise NotImplementedError(
            "configuration outside the fused rollout's envelope "
            "(ops.fused_rollout.supports)")
    X, Y, Z = body.occ.shape[-3:]
    B = state.scale.shape[0]
    state_packed = pack_state(state)
    body_packed = pack_body(body)
    collision_packed = None
    if sim.self_collisions_enabled and body.collision is not None:
        collision_packed = torch.as_tensor(
            pack_collision(body.collision, (X, Y, Z)),
            device=state_packed.device)[None]
    if stats is None:
        stats = make_stats(body, B, dt, sim, env, stop_time)
    flags = dict(kernel_env_flags(sim, env), **body_flags(body),
                 collision=collision_packed is not None)
    n_knots, control_packed = 0, None
    if control_sequence is not None:
        n_knots = control_sequence.shape[1]
        control_packed = _flat(control_sequence.to(torch.float32),
                               (B, n_knots)).contiguous()
    out_state, out_stats = fused_call(
        state_packed, body_packed, stats, collision_packed,
        control_packed=control_packed, num_steps=num_steps,
        grid_shape=(X, Y, Z), scalars=kernel_scalars(body.nominal_size, sim, env),
        flags=flags, n_knots=n_knots, prec=prec)
    outs = stats_to_outputs(out_stats)
    new_state = unpack_state(out_state, state, (X, Y, Z)).replace(
        time=outs.time.to(state.time.dtype), diverged=outs.diverged)
    return new_state, outs


class FusedBatchRunner:
    """Reusable packed-batch rollout launcher for solver loops (CEM, MPC).

    Packs one design's state, body, stats and pair table once, on the body's
    device; each `run(controls)` is one K1 launch over the candidate batch.
    Controls are (B, K, X, Y, Z) scale-modulation knots (the eager step's
    `control_offset` channel). `call_kwargs` are the launch's keyword
    arguments, for solvers that call `fused_call` on the packed fields
    themselves."""

    def __init__(self, body: VoxelBody, sim: SimParams, env: EnvParams,
                 batch: int, num_steps: int, num_knots: int, dt=None,
                 state: SimState | None = None, stop_time=None,
                 prec: Precision = DEFAULT_PRECISION):
        from evosoro_tpu_torch.core.materials import calc_max_dt
        from evosoro_tpu_torch.core.rollout import init_state

        if not supports(body, sim, env):
            raise NotImplementedError(
                "configuration outside the fused rollout's envelope "
                "(ops.fused_rollout.supports)")
        if dt is None:
            dt = calc_max_dt(body) * sim.dt_frac
        if state is None:
            state = init_state(body)
        X, Y, Z = body.occ.shape[-3:]
        self.grid_shape = (X, Y, Z)
        self.L = body.nominal_size
        self.num_steps = num_steps
        self.num_knots = num_knots
        self.batch = batch
        self.state_packed = pack_state_single(state)[None].expand(
            batch, -1, -1).contiguous()
        self.body_packed = pack_body(body)
        self.collision_packed = None
        if sim.self_collisions_enabled and body.collision is not None:
            self.collision_packed = torch.as_tensor(
                pack_collision(body.collision, self.grid_shape),
                device=self.state_packed.device)[None]
        self.stats = make_stats(body, batch, dt, sim, env, stop_time)
        self.call_kwargs = dict(
            num_steps=num_steps, grid_shape=self.grid_shape,
            scalars=kernel_scalars(body.nominal_size, sim, env),
            flags=dict(kernel_env_flags(sim, env), **body_flags(body),
                       collision=self.collision_packed is not None),
            n_knots=num_knots, prec=prec)

    def run(self, controls):
        """controls (B, K, X, Y, Z) -> `packed_metrics` of every candidate."""
        ctrl = _flat(controls.to(torch.float32),
                     (self.batch, self.num_knots)).contiguous()
        out_state, out_stats = fused_call(
            self.state_packed, self.body_packed, self.stats,
            self.collision_packed, control_packed=ctrl, **self.call_kwargs)
        return packed_metrics(out_state, self.body_packed, out_stats, self.L)
