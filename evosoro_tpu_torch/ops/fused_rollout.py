"""Fused multi-step rollout: host side, plain versions and kernel wrappers.

The port of `evosoro_tpu/ops/fused_rollout.py`. The TPU kernel there
(`_make_kernel`, launched by `_fused_call`) advances B robots for
`num_steps` with the state held on chip; here three CUDA kernels written for
Hopper take its place on the evolution loop's envelope:

- K1 (`fused_call`, `csrc/fused_rollout.cu`): the forward multi-step
  rollout, one block per robot, the step loop inside the kernel, with the
  MPC control-knot channel and the segmented mode (a launch that advances
  `num_steps` of a longer rollout from a global step offset), the fluid
  environment's branches (facet drag on the deformed surface mesh as a
  corner-lattice stencil, voxel-face drag, the land_water actuation) and
  the linear development ramps, each compiled as its own variant, and
  the fitness features (environmental sources, needle-in-haystack, the
  fall-over latch, NormDistByVol, speed windows and ballistic development),
  compiled as a second instance of each variant, and Voxelyze's material,
  solver and boundary options on land (bilinear and MDL_DATA stress with
  the stress-equalization loop, plasticity, the max-velocity clamp,
  equilibrium mode, boundary-condition regions) with the surface-compacted
  contact pass, compiled as a third instance of the land variant, and
  volume effects (the Poisson-coupled stress with its thermal term, the
  per-step dt and the voxel pass's transverse coupling), a fourth, in a
  kernel of its own beside the third;
- B4 (`fused_bwd_call`, `csrc/fused_rollout_bwd.cu`): the reverse-mode
  segment, the adjoint of K1's step written by hand, which pulls a
  segment's end-state cotangent back to its start state and the control
  knots (the JAX package's `_fused_bwd_call`);
- K2 (`pair_contact_forces`, `csrc/pair_contact.cu`): the dense
  self-contact pass, a device routine of K1 that also has its own launch;
  the same routine over the surface voxels is the surface-compacted pass
  (B5), whose own launch is `pair_contact_forces_compact`.

Every K1 and B4 kernel has a device-memory twin that keeps the robot's
buffer in device memory in place of one block's shared memory; the
wrappers pick it by the body's shape (`k1_instance`, `b4_launch_shape`),
so bodies of any size run (the JAX kernel's VMEM takes a 13^3 body with
contact, any body without).

Each wrapper takes its kernel for CUDA tensors and its plain PyTorch
version (`fused_rollout_plain`, `pair_contact_forces_plain`,
`pair_contact_forces_compact_plain`, `fused_bwd_plain`) for CPU
tensors. There is no fallback: a build failure, a launch failure or a
feature outside the envelope on a CUDA tensor raises.

The packed channel maps `C_S`/`C_B`/`C_STAT` and their offsets are kept
identical to the JAX package so states and stats compare channel by channel.
The port's own layout has no lane padding: V = X*Y*Z voxels, flat x-major.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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
from evosoro_tpu_torch.core.types import DevoState, EnvParams, SimParams, SimState, VoxelBody
from evosoro_tpu_torch.envs.sources import REF_PI_VEC3D
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
# volume effects: each bond direction's mean transverse strain sum and
# cross-section over its two sides, for the next step's stress
_TSAVG = 47  # 47..49
_CSAVG = 50  # 50..52
_SOFF = 53  # 53..55 plastic strain offset
# ballistic development's per-voxel fields, rebased every step
# (VXS_Voxel.cpp:342-381): initial size, final size, growth time, start
_DEVO_DYN = 56  # 56..59
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

# shared floats a voxel K1 needs for the bond forces (csrc/fused_rollout.cu:
# BF); the fluid-mesh variant works inside the same 36 (its vertex field and
# the force sums it carries across its extra barrier live in slots of the
# bond buffer that only the voxel itself reads). Contact adds 3 a voxel for
# its forces and the pair pass's staging and tables (csrc/pair_contact.cuh)
# over its entries: the surface voxels with the compact pass, else all
_K1_SMEM_FLOATS = 36
# per-voxel floats of device-memory scratch a fluid-mesh launch needs: the
# per-side strains sv1, sv2 of the three bonds a voxel owns
_K1_MESH_SCRATCH = 6
# ... and a volume launch: the strains of the three bonds a voxel owns, then
# its transverse sums and cross-sections per bond axis (the voxel pass
# hands them to the bond owners through device memory, so volume effects
# add no shared memory)
_K1_VOL_SCRATCH = 9
_SMEM_BYTES = 232448  # a block's shared memory on Hopper, static and dynamic
# K1's static shared memory as ptxas reports it: 112 bytes (the block
# reductions' scratch and the divergence flags), 208 in the feature instance
# (the window ring); the dynamic part gets what is left. Ceilings: 1339
# cells with dense contact, 1612 without (the instance without features fits
# one more, 1613). Volume effects add none: their block max reuses the
# reductions' scratch, and their exchanges go through device memory. B4's
# recompute takes K1's buffer without contact (36 floats a voxel) under the
# same rule; its C entry places its reverse sweep's slabs (`b4_launch_shape`)
_K1_STATIC_SMEM = 208


def pair_groups(V: int) -> int:
    """32-voxel groups of a body of V grid cells: the dense pair pass's row
    and column groups (csrc/pair_contact.cuh pair_groups)."""
    return (V + 31) // 32


def pair_table_words(V: int) -> int:
    """32-bit words of the dense pass's static tile mask (a word for each 32
    column groups of a row group) and active-voxel bits (a word a group)
    (csrc/pair_contact.cuh pair_table_words)."""
    G = pair_groups(V)
    return G * ((G + 31) // 32) + G


def pair_pass_floats(V: int) -> int:
    """Floats the pair pass keeps beside the bond forces over V entries
    (csrc/pair_contact.cuh; the voxels, or the compact pass's surface
    voxels): the staged positions and scales, a float4 an entry padded to
    whole groups (128 a group), a box of 8 floats a group and the tile mask
    and active bits (`pair_table_words`)."""
    return 136 * pair_groups(V) + pair_table_words(V)


def k1_buffer_floats(V: int, collision: bool, n_surf=None) -> int:
    """Floats of K1's per-robot buffer for a body of V grid cells: the bond
    forces, and with contact the contact forces and the pair pass's float4s
    and tables (`pair_pass_floats`) over the surface-compacted pass's
    `n_surf` surface voxels, or over the V voxels, the whole rounded up to
    a multiple of 4 so that each row of the device-memory twins' buffer
    keeps the float4s aligned (csrc/fused_rollout_common.cuh
    k1_buffer_floats)."""
    if not collision:
        return _K1_SMEM_FLOATS * V
    n = (_K1_SMEM_FLOATS + 3) * V + pair_pass_floats(V if n_surf is None else int(n_surf))
    return (n + 3) // 4 * 4


def k1_fits(V: int, collision: bool, n_surf=None) -> bool:
    """True when K1's shared memory holds a body of V grid cells
    (`k1_buffer_floats`) beside its static part."""
    return k1_buffer_floats(V, collision, n_surf) * 4 + _K1_STATIC_SMEM <= _SMEM_BYTES


def k1_instance(V: int, collision: bool, n_surf=None) -> str:
    """Where K1 and B4 keep a robot's buffer for a body of V grid cells:
    "shared" while one block's shared memory holds it (`k1_fits`), else
    "device", the instances that keep it in device memory. B4 asks without
    contact (its buffer is the bond forces' 36 floats a voxel)."""
    return "shared" if k1_fits(V, collision, n_surf) else "device"


def k1_resident(V: int, collision: bool, n_surf=None) -> bool:
    """True when the robot's state (C_S x V floats) stays in K1's shared
    memory across a launch: where it fits beside the buffer
    (`k1_buffer_floats`) and the static part, about V <= 540 with contact
    and V <= 580 without, every evolution body."""
    return (k1_buffer_floats(V, collision, n_surf) + C_S * V) * 4 + _K1_STATIC_SMEM \
        <= _SMEM_BYTES


def k1_launch_shape(grid_shape, flags: dict, scalars: dict, n_surf=None) -> dict:
    """How K1 runs a launch of these flags and scalars on this grid
    (`n_surf`: the compact table's surface count): `instance` ("shared" or
    "device", `k1_instance`), whether the state is `resident` in shared
    memory (`k1_resident`, shared instances only, and only those with a
    resident half: the material and volume instances in water and with
    growth have none, a speed choice) and the `threads` a block that the
    launcher takes (csrc/k1_step.cuh `k1_threads`); the last two asked of
    the built library (csrc/fused_rollout.cu), which needs the CUDA
    toolkit."""
    V = int(np.prod(grid_shape))
    coll = bool(flags.get("collision"))
    instance = k1_instance(V, coll, n_surf)
    bits = _flag_bits(flags)
    threads = build.function("fused_rollout", "fused_rollout_k1_threads",
                             [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    half = build.function("fused_rollout", "fused_rollout_k1_resident_half", [ctypes.c_int])
    return dict(instance=instance,
                threads=threads(V, bits, int(coll),
                                _feat_params(scalars, flags).ctypes.data_as(ctypes.c_void_p)),
                resident=instance == "shared" and bool(half(bits))
                and k1_resident(V, coll, n_surf))


def _bond_buffer(B: int, floats: int, device):
    """The device-memory instances' (B, floats) buffer, a row a robot (the
    kernel reads the row stride)."""
    return torch.empty((B, floats), dtype=torch.float32, device=device)


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
    if state.ts_sum is not None:
        # the step reads only the two sides' means
        for d in range(3):
            chans[_TSAVG + d] = f(0.5 * (state.ts_sum[:, 0, d] + state.ts_sum[:, 1, d]))
            chans[_CSAVG + d] = f(0.5 * (state.cs_area[:, 0, d] + state.cs_area[:, 1, d]))
    if state.strain_offset is not None:
        for d in range(3):
            chans[_SOFF + d] = f(state.strain_offset[:, d])
    if state.devo is not None:
        for k, name in enumerate(_DEVO_DYN_FIELDS):
            chans[_DEVO_DYN + k] = f(getattr(state.devo, name).expand_as(state.scale))
    return torch.stack(chans, dim=1).contiguous()


_DEVO_DYN_FIELDS = ("initial_voxel_size", "final_voxel_size", "growth_time",
                    "start_growth_time")


def _add_batch(v):
    """A tensor, or each tensor of a DevoState, with a leading batch of one."""
    if v is None:
        return None
    if isinstance(v, DevoState):
        return v.replace(**{f.name: _add_batch(getattr(v, f.name))
                            for f in dataclasses.fields(DevoState)})
    return v[None]


def pack_state_single(state: SimState, dtype=torch.float32):
    """Unbatched SimState -> (C_S, V)."""
    batched = SimState(**{f.name: _add_batch(getattr(state, f.name))
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
    extra = {}
    if template.strain_offset is not None:
        extra["strain_offset"] = torch.stack([g(_SOFF + d) for d in range(3)], dim=1)
    if template.ts_sum is not None:
        # both sides get the mean, which is all the step reads
        for name, base in (("ts_sum", _TSAVG), ("cs_area", _CSAVG)):
            side = torch.stack([g(base + d) for d in range(3)], dim=1)
            extra[name] = torch.stack([side, side], dim=1)
    if template.devo is not None:
        extra["devo"] = template.devo.replace(**{
            name: g(_DEVO_DYN + k) for k, name in enumerate(_DEVO_DYN_FIELDS)})
    return template.replace(
        **extra,
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


def pack_collision_compact(colsys, grid_shape):
    """CollisionSystem -> the surface-compacted (S + 1, S) float32 numpy
    table of K1's compact contact pass, S the live surface voxels: row 0
    their flat x-major voxel indices (exact in float32 below 2^24), rows 1..S
    their pair-stiffness table (the JAX package's `pack_collision_compact`
    stacks a one-hot (Vp, Sp) gather matrix on the same table instead)."""
    X, Y, Z = grid_shape
    sidx = np.asarray(colsys.surf_idx)
    smask = np.asarray(colsys.surf_mask).astype(bool)
    live = np.nonzero(smask)[0]
    flat = sidx[live, 0] * (Y * Z) + sidx[live, 1] * Z + sidx[live, 2]
    out = np.zeros((len(live) + 1, len(live)), np.float32)
    out[0] = flat
    out[1:] = np.asarray(colsys.pair_a1)[np.ix_(live, live)]
    return out


def pack_ss_tables(body: VoxelBody, dtype=torch.float32):
    """MDL_DATA per-voxel stress-strain tables -> (1, 2P+3, V), or (B, 2P+3,
    V) for a batch of bodies, in the JAX package's channel order (xs_0..
    xs_{P-1}, ys_0..ys_{P-1}, fail strain, last stress, last slope). Given
    to K1 only when a palette entry is MDL_DATA."""
    lead = tuple(body.occ.shape[:-3])
    P = body.ss_strain_vox.shape[-1]
    f = lambda a: _flat(a, lead).to(dtype)  # noqa: E731
    chans = [f(body.ss_strain_vox[..., k]) for k in range(P)]
    chans += [f(body.ss_stress_vox[..., k]) for k in range(P)]
    chans += [f(body.ss_fail_strain_vox), f(body.ss_last_stress_vox),
              f(body.ss_last_slope_vox)]
    out = torch.stack(chans, dim=-2)
    return (out if lead else out[None]).contiguous()


def pack_bc_tables(body: VoxelBody, dtype=torch.float32):
    """Boundary-condition channels -> (1, 15, V), or (B, 15, V) for a batch
    of bodies, in the JAX package's order: the 6 DOF-fixed bits (X, Y, Z,
    TX, TY, TZ), the external force, the prescribed displacement and the
    prescribed rotation vector (reference regions: VX_FRegion.h DOF masks;
    applied in VXS_Voxel EulerStep)."""
    lead = tuple(body.occ.shape[:-3])
    f = lambda a: _flat(a, lead).to(dtype)  # noqa: E731
    dof = body.dof_fixed.expand(body.occ.shape)
    chans = [f((dof >> k) & 1) for k in range(6)]
    for field in (body.external_force, body.external_disp, body.external_tdisp):
        field = field.expand(body.occ.shape + (3,))
        chans += [f(field[..., c]) for c in range(3)]
    out = torch.stack(chans, dim=-2)
    return (out if lead else out[None]).contiguous()


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
    """Per-rollout outputs of the fused rollout; the feature channels are
    zeros unless their feature is on."""

    time: Any  # (B,)
    diverged: Any  # (B,) bool
    ini_cm: Any  # (B, 3)
    cm_captured: Any  # (B,) bool
    source_min_dist: Any = None  # (B, n_src) final min distances
    source_avg_min_dist: Any = None  # (B, n_src) history means
    fell_over: Any = None  # (B,) bool fall-over latch
    norm_dist_by_vol: Any = None  # (B,) whole-life sum of dy/L/vol^exp
    norm_regime_dist_by_vol: Any = None  # (B,) afterlife sum
    norm_frozen_dist_by_vol: Any = None  # (B,) frozen-window sum
    norm_window_dist: Any = None  # (B,) last completed window distance
    win_prev_dist: Any = None  # (B,) previous completed window
    win_count: Any = None  # (B,)
    ini_needle: Any = None  # (B, 3) initial needle position
    end_of_life_posterior_y: Any = None  # (B,) lattice units


def stats_to_outputs(stats) -> FastRolloutStats:
    return FastRolloutStats(
        time=stats[:, _S_TIME],
        diverged=stats[:, _S_DIV] > 0.5,
        ini_cm=stats[:, _S_INICM:_S_INICM + 3],
        cm_captured=stats[:, _S_CAPT] > 0.5,
        fell_over=stats[:, _S_FELL] > 0.5,
        norm_dist_by_vol=stats[:, _S_ND],
        norm_regime_dist_by_vol=stats[:, _S_NDRG],
        norm_frozen_dist_by_vol=stats[:, _S_NDFZ],
        norm_window_dist=stats[:, _S_WLAST],
        win_prev_dist=stats[:, _S_WPREV],
        win_count=stats[:, _S_WCNT],
        ini_needle=stats[:, _S_NEEDLE:_S_NEEDLE + 3],
        end_of_life_posterior_y=stats[:, _S_EOLY],
    )


def packed_metrics(out_state, body_packed, out_stats, L, *, ndbv=False,
                   falling=False, needle=False, window=False, grid_z=0):
    """Locomotion fitness straight off the packed outputs: NormFinalDist =
    |ΔCoM_xy|/L (reference: VX_SimGA.cpp:36), 0 for diverged rollouts; with
    the feature keywords also the NormDistByVol family (VX_SimGA.cpp:58-117),
    the fall-over zeroing and FallAdjPostY with the workspace height `grid_z`
    (VX_SimGA.cpp:115-126), the needle's push distance (VX_SimGA.cpp:45-55)
    and the last completed window distance."""
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

    zero = torch.zeros_like(dist)
    norm_final_dist, norm_regime_dist, norm_frozen_dist = dist, zero, zero
    if ndbv:
        norm_final_dist = out_stats[:, _S_ND]
        norm_regime_dist = out_stats[:, _S_NDRG]
        norm_frozen_dist = out_stats[:, _S_NDFZ]
    eoly = out_stats[:, _S_EOLY]
    fall_adj_post_y = eoly
    if falling:
        fell = out_stats[:, _S_FELL] > 0.5
        fall_adj_post_y = torch.where(fell, eoly - grid_z, eoly)
        norm_final_dist = torch.where(fell, 0.0, norm_final_dist)
        norm_regime_dist = torch.where(fell, 0.0, norm_regime_dist)
        norm_frozen_dist = torch.where(fell, 0.0, norm_frozen_dist)
    # the headline fitness subtracts the frozen-window distance
    # (VX_SimGA.cpp:145; zero when NormDistByVol is off)
    norm_final_dist = norm_final_dist - norm_frozen_dist

    push_dist, found_needle = zero, zero
    if needle:
        is7 = torch.where((body_packed[:, _B_MAT, :] - 7.0).abs() < 0.5, 1.0, 0.0)
        n7 = torch.clamp(is7.sum(1), min=1.0)
        nd = [(is7 * out_state[:, _POS + c, :]).sum(1) / n7 - out_stats[:, _S_NEEDLE + c]
              for c in range(2)]
        ndsq = nd[0] * nd[0] + nd[1] * nd[1]
        push_dist = torch.where(ndsq > 0, torch.sqrt(torch.where(ndsq > 0, ndsq, 1.0)),
                                0.0) / L
        found_needle = (ndsq > 0).to(dist.dtype)

    return dict(
        norm_final_dist=torch.where(diverged, 0.0, norm_final_dist),
        final_dist_y=delta[:, 1] / L,
        diverged=diverged,
        final_cm=final_cm,
        ini_cm=ini_cm,
        final_time=out_stats[:, _S_TIME],
        norm_regime_dist=norm_regime_dist,
        norm_frozen_dist=norm_frozen_dist,
        fall_adj_post_y=fall_adj_post_y,
        end_of_life_posterior_y=eoly,
        push_dist=push_dist,
        found_needle=found_needle,
        norm_window_dist=out_stats[:, _S_WLAST],
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


def _source_statics(env: EnvParams):
    """The enabled sources' (base xyz, amplitude xyz, frequency xyz) as
    9-tuples of Python floats: design-time constants of a launch."""
    if env.sources is None:
        return ()
    s = env.sources
    rows = []
    for k in range(s.num_sources):
        if not bool(s.enabled[k]):
            continue
        rows.append(tuple(float(v) for v in (*s.base_pos[k].tolist(), *s.amp[k].tolist(),
                                             *s.freq[k].tolist())))
    return tuple(rows)


def kernel_scalars(L, sim: SimParams, env: EnvParams) -> dict:
    """The design-time float constants of a launch (the JAX package's
    `kernel_scalars`, same keys). `sc_value` is the lifetime's end, the
    afterlife regime's boundary; a robot's stop time rides its stats row."""
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
        sources=_source_statics(env),
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
    """The body-derived flags the JAX host side adds to `kernel_env_flags`
    (`ballistic` follows the state: callers that carry a DevoState set it)."""
    from evosoro_tpu_torch.core.step import has_bc

    return dict(
        nonlinear=not bool(body.all_linear),
        mdl_data=body.ss_strain_vox is not None,
        bc=has_bc(body),
        fluid_mesh=body.mesh_drag is not None,
        use_init_size=bool(body.using_initial_voxel_size),
        use_final_size=bool(body.using_final_voxel_size),
        use_growth_t=bool(body.using_growth_time),
        use_final_phase=bool(body.using_final_phase_offset),
        use_final_ad=bool(body.using_final_temp_amp_damp),
        ballistic=False,
    )


def facet_drag(flags: dict) -> bool:
    """True when a launch with these flags runs the facet drag: the body
    carries mesh tables and the environment is a fluid (on land the tables
    are inert)."""
    return bool(flags.get("fluid") and flags.get("fluid_mesh"))


def launch_flags(body: VoxelBody, sim: SimParams, env: EnvParams, **extra) -> dict:
    """The flags of a launch for one design: `kernel_env_flags`, the
    body-derived flags and `extra` (collision, segmented). A body that
    would run the facet drag without the corner shell raises here, where the
    launch is put together, so that `fused_call` need not look at the body
    again on every launch."""
    flags = {**kernel_env_flags(sim, env), **body_flags(body), **extra}
    if facet_drag(flags) and not has_corner_shell(body.occ):
        raise ValueError(NO_SHELL)
    return flags


# flags K1 implements, as the bits csrc/fused_rollout_common.cuh reads
_K1_FLAG_BITS = dict(floor=1, sticky=2, gravity=4, temp=8, freeze_on=16,
                     collision=32, temp_enabled=64, fluid=128, fluid_mesh=256,
                     use_init_size=512, use_final_size=1024, use_growth_t=2048,
                     use_final_phase=4096, use_final_ad=8192, needle=16384,
                     falling=32768, ndbv=65536, window=131072, ballistic=262144,
                     nonlinear=1 << 19, mdl_data=1 << 20, plasticity=1 << 21,
                     equilibrium=1 << 22, max_vel=1 << 23, bc=1 << 24,
                     collision_compact=1 << 25, volume=1 << 26)
_K1_DEVO_FLAGS = ("use_init_size", "use_final_size", "use_growth_t",
                  "use_final_phase", "use_final_ad")
# the fitness features: a launch with any of them (or a source) runs K1's
# feature instance; those that sample the CoM/volume trace
_K1_FEATURE_FLAGS = ("needle", "falling", "ndbv", "window", "ballistic")
_K1_TRACE_FLAGS = ("ndbv", "window", "ballistic")
# Voxelyze's material, solver and boundary options, the compact contact pass
# and volume effects: a launch with any of them runs K1's material instance
# of its variant (with and without the features; with volume effects, an
# instance of its own)
_K1_MAT_FLAGS = ("nonlinear", "mdl_data", "plasticity", "equilibrium", "max_vel", "bc",
                 "collision_compact", "volume")
# trace-sample ring slots K1 carries per robot, and the sources it tracks
MAX_KERNEL_WINDOW = 12
MAX_KERNEL_SOURCES = 3


def _flag_bits(flags: dict) -> int:
    """The launch's feature bits. The facet drag runs only in a fluid; in a
    fluid the development ramps are inert (the land_water actuation
    bypasses them), so their bits stay off."""
    on = {k for k in _K1_FLAG_BITS if flags.get(k)}
    if not facet_drag(flags):
        on.discard("fluid_mesh")
    if "equilibrium" in on:  # the mode turns the clamp off (VX_Sim.cpp:1351-1372)
        on.discard("max_vel")
    if "fluid" in on:
        on.difference_update(_K1_DEVO_FLAGS)
    return sum(_K1_FLAG_BITS[k] for k in on)


def check_envelope(flags: dict, scalars: dict):
    """Raise NotImplementedError for any flag outside K1's envelope (for
    CPU and CUDA tensors alike, before anything runs). The material and
    volume options run in every variant."""
    # a fluid's actuation is gated on temp_enabled alone
    if flags.get("temp_enabled") and not flags.get("temp") and not flags.get("fluid"):
        raise NotImplementedError("fused rollout: a fixed (non-varying) "
                                  "temperature is not ported yet")
    # the ballistic rebase runs on the land development ramps; in a fluid the
    # JAX kernel rebases from ramps its actuation ignores, while its eager
    # step does not rebase at all
    if flags.get("ballistic") and (flags.get("fluid") or not flags.get("use_final_size")):
        raise NotImplementedError("fused rollout: 'ballistic' development runs on "
                                  "land with an evolved final size only")
    if len(scalars.get("sources", ())) > MAX_KERNEL_SOURCES:
        raise NotImplementedError(f"fused rollout: more than {MAX_KERNEL_SOURCES} "
                                  "environmental sources")
    n_win = int(flags.get("n_win", 0) or 0)
    if bool(flags.get("window")) != (n_win > 0) or n_win > MAX_KERNEL_WINDOW:
        raise ValueError(f"fused rollout: 'window' needs 1-{MAX_KERNEL_WINDOW} "
                         f"trace steps in a window, got n_win={n_win}")
    if any(flags.get(k) for k in _K1_TRACE_FLAGS) and not scalars.get("tb", 0) > 0:
        raise ValueError("fused rollout: the trace features need time_between_traces > 0")


NO_SHELL = ("facet drag needs an empty layer on the grid's +X, +Y and +Z "
            "faces (ops.fused_rollout.supports)")


def has_corner_shell(occ) -> bool:
    """True when no voxel of `occ` (..., X, Y, Z; a tensor or a numpy array)
    lies on the grid's last +X, +Y or +Z layer: the facet-drag stencil keeps
    the vertex at a voxel's min corner in that voxel's cell, so every corner
    of an occupied voxel needs a cell of its own."""
    return not bool(occ[..., -1, :, :].any() or occ[..., :, -1, :].any()
                    or occ[..., :, :, -1].any())


def supports(body: VoxelBody, sim: SimParams, env: EnvParams) -> bool:
    """True when (body, sim, env) is inside K1's envelope, at any body size
    (past one block's shared memory K1's device-memory instances run it,
    `k1_instance`). A fluid body with mesh-drag tables needs an empty
    layer on its +X, +Y and +Z faces (pad the structure by one; the
    evaluator does). The features: at most MAX_KERNEL_SOURCES sources, at
    most MAX_KERNEL_WINDOW trace steps in a window, and a positive time
    between traces for windows and NormDistByVol (the JAX package's rule,
    which counts disabled sources too)."""
    return refusal(body, sim, env) is None


def refusal(body: VoxelBody, sim: SimParams, env: EnvParams):
    """Why (body, sim, env) is outside K1's envelope, as a message, or None
    when `supports()` is true."""
    if env.floor_limited:
        return "fused rollout: the limited floor is not a K1 feature"
    if env.sources is not None and env.sources.num_sources > MAX_KERNEL_SOURCES:
        return f"fused rollout: more than {MAX_KERNEL_SOURCES} environmental sources"
    try:
        flags = launch_flags(body, sim, env)  # raises without the shell
        check_envelope(flags, kernel_scalars(body.nominal_size, sim, env))
    except (NotImplementedError, ValueError) as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# K2: dense pair contact
# ---------------------------------------------------------------------------

# launches of K2's own kernel (K1 runs K2's routine inside its launch; those
# are counted by FUSED_ROLLOUT_CONTACT_LAUNCHES)
PAIR_CONTACT_LAUNCHES = 0
# the dense pass's cull margin: a tile of the table is evaluated when its
# row and column groups' boxes lie closer than 0.75 (smax_g + smax_h) (1 +
# this), which keeps every touching pair (the argument heads
# csrc/pair_contact.cuh). Its one source: K1 takes 1 + this in its
# constants (`_k1_params`), K2 this as an argument
PAIR_CULL_MARGIN = 1e-3
# warps of a K2 pass block (csrc/pair_contact.cu K2_THREADS / 32)
_K2_WARPS = 8


def _k2_smem_bytes(V: int) -> int:
    """Shared bytes of a K2 block: the pair pass's staging and tables and
    the warps' partial sums (csrc/pair_contact.cu k2_smem)."""
    return 4 * (pair_pass_floats(V) + _K2_WARPS * 96)


def pair_contact_forces_plain(pos, scale, a1, row_sum=None):
    """Plain version of K2: a transliteration of the JAX package's
    `_pair_contact_forces` over a batch. pos (..., 3, V), scale (..., V),
    a1 (..., V, V) or (V, V) -> forces (..., 3, V) on each voxel. Large
    batches are processed in chunks to bound the (V, V) temporaries.
    row_sum: sums the terms (n, 3, V, V) over their last axis, `.sum(-1)`
    when None (chip_smoke.py passes the kernels' order, to hold K1's
    contact steps to the plain version bit for bit)."""
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
        terms = mag[:, None] * diff
        out[lo:hi] = -(terms.sum(-1) if row_sum is None else row_sum(terms))
    return out.reshape(lead + (3, V))


def pair_tile_census_plain(pos, scale, a1, margin=PAIR_CULL_MARGIN, idx=None):
    """The pair pass's tile counts, summed over the batch, in float32 as
    the routine computes them: (evaluated, culled by distance, culled
    statically) 32 x 32 tiles of the table. pos (B, 3, V), scale (B, V), a1
    (B or 1, V, V); or, for the compact pass, a1 its (B or 1, S, S)
    stiffnesses and idx its (B or 1, S) index row (the surface voxels, in
    the table's order). Its tests are the routine's: the static mask (a
    nonzero entry in the tile), the active entries (a nonzero in their row
    or column), each group's box over them and the gap against 0.75
    (smax_g + smax_h) (1 + margin) (csrc/pair_contact.cuh)."""
    if idx is not None:
        ix = idx.long().expand(pos.shape[0], -1)
        pos = torch.gather(pos, 2, ix[:, None, :].expand(-1, 3, -1))
        scale = torch.gather(scale, 1, ix)
    B, _, V = pos.shape
    G = pair_groups(V)
    pad = 32 * G - V
    f32 = torch.float32
    nz = torch.nn.functional.pad(a1.reshape(-1, V, V) != 0, (0, pad, 0, pad))
    mask = nz.reshape(-1, G, 32, G, 32).any(4).any(2)  # (1 or B, G, G)
    act = (nz.any(2) | nz.any(1)).reshape(-1, G, 32)  # row or column
    p = torch.nn.functional.pad(pos.to(f32), (0, pad)).reshape(B, 3, G, 32)
    s = torch.nn.functional.pad(scale.to(f32), (0, pad)).reshape(B, G, 32)
    inf = torch.tensor(float("inf"), dtype=f32)
    lo = torch.where(act[:, None], p, inf).amin(-1)  # (B, 3, G)
    hi = torch.where(act[:, None], p, -inf).amax(-1)
    smax = torch.where(act, s, torch.zeros((), dtype=f32)).amax(-1)  # (B, G)
    zero = torch.zeros((), dtype=f32)
    gap = torch.maximum(torch.maximum(lo[:, :, None, :] - hi[:, :, :, None],
                                      lo[:, :, :, None] - hi[:, :, None, :]), zero)
    gap2 = gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1] + gap[:, 2] * gap[:, 2]
    slack = torch.tensor(1.0, dtype=f32) + torch.tensor(margin, dtype=f32)
    r = (0.75 * (smax[:, :, None] + smax[:, None, :])) * slack
    near = gap2 < r * r  # (B, g, h)
    mask = mask.expand(B, G, G)
    return (int((mask & near).sum()), int((mask & ~near).sum()), int((~mask).sum()))


def pair_contact_forces(pos, scale, a1, *, counts=None):
    """K2 wrapper. pos (B, 3, V), scale (B, V), a1 (B or 1, V, V), float32
    and contiguous -> forces (B, 3, V). CUDA tensors launch the kernel;
    CPU tensors run `pair_contact_forces_plain`. `counts`, an int32 tensor
    of 3 on the card, receives the launch's tile counts added to it
    (evaluated, culled by distance, culled statically; the
    `pair_tile_census_plain` of these inputs)."""
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
        if counts is not None:
            raise ValueError("tile counts come from the kernel: pair_tile_census_plain "
                             "computes them on the CPU")
        return pair_contact_forces_plain(pos, scale, a1)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    for name, t in (("pos", pos), ("scale", scale), ("a1", a1)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if counts is not None and (counts.dtype != torch.int32 or tuple(counts.shape) != (3,)
                               or counts.device != pos.device):
        raise ValueError("counts must be an int32 tensor of 3 on the inputs' device")
    if _k2_smem_bytes(V) > _SMEM_BYTES:
        raise ValueError(f"V={V} voxels overflow K2's shared memory")
    out = torch.empty_like(pos)
    # each table's tile mask and active bits, which the first launch ORs into
    tables = torch.zeros((a1.shape[0], pair_table_words(V)), dtype=torch.int32,
                         device=pos.device)
    fn = build.library("pair_contact")
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(pos.data_ptr(), scale.data_ptr(), a1.data_ptr(), out.data_ptr(),
                B, V, int(a1.shape[0] == B and B > 1), PAIR_CULL_MARGIN, tables.data_ptr(),
                counts.data_ptr() if counts is not None else None, stream)
    build.check(rc, "pair_contact_forces")
    global PAIR_CONTACT_LAUNCHES
    PAIR_CONTACT_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# B5: surface-compacted pair contact (a routine of K1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompactTable:
    """A body's surface-compacted pair table, (1 or B, S + 1, S)
    (`pack_collision_compact`), as the eager step's `body.collision`."""

    table: Any


def pair_contact_forces_compact_plain(pos, scale, table, row_sum=None):
    """Plain version of K1's compact contact pass (the JAX package's
    `_pair_contact_forces_compact`): gather the S surface voxels' positions
    and scales through the index row of `table`, evaluate the (S, S) pair
    field `mag = a1 (0.75 (s_i + s_j) / dist - 1)` where positive, and scatter
    `-sum_j mag (p_j - p_i)` back to the voxels; the others receive -0, as
    the dense pass's zero rows give them. pos (..., 3, V), scale (..., V),
    table (..., S + 1, S) or (S + 1, S) -> forces (..., 3, V). row_sum: as
    `pair_contact_forces_plain`'s, over the (n, 3, S, S) terms."""
    lead = pos.shape[:-2]
    V = pos.shape[-1]
    p = pos.reshape(-1, 3, V)
    sc = scale.reshape(-1, V)
    tab = table.reshape((-1,) + tuple(table.shape[-2:]))
    tab = tab.expand(p.shape[0], -1, -1) if tab.shape[0] == 1 else tab
    idx = tab[:, 0, :].long()  # (n, S)
    a1 = tab[:, 1:, :]
    ps = torch.gather(p, 2, idx[:, None, :].expand(-1, 3, -1))  # (n, 3, S)
    ss = torch.gather(sc, 1, idx)
    diff = ps[:, :, None, :] - ps[:, :, :, None]  # [c, i, j] = p_j - p_i
    dist2 = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2]
    inv = torch.rsqrt(torch.clamp(dist2, min=1e-30))
    tt = 0.75 * (ss[:, :, None] + ss[:, None, :]) * inv
    mag = torch.where(tt > 1.0, a1 * (tt - 1.0), 0.0)
    terms = mag[:, None] * diff
    fs = -(terms.sum(-1) if row_sum is None else row_sum(terms))  # (n, 3, S)
    out = torch.full_like(p, -0.0)
    out.scatter_(2, idx[:, None, :].expand(-1, 3, -1), fs)
    return out.reshape(lead + (3, V))


# launches of the compact pass's own kernel (K1 runs the pass inside its
# launch; those are counted by FUSED_ROLLOUT_COMPACT_LAUNCHES)
PAIR_CONTACT_COMPACT_LAUNCHES = 0


def pair_contact_forces_compact(pos, scale, table, *, counts=None):
    """The compact pass's own launch (csrc/pair_contact_compact.cu: a block a
    robot runs the pass as K1's step does). pos (B, 3, V), scale (B, V),
    table (B or 1, S + 1, S) (`pack_collision_compact`), float32 and
    contiguous -> forces (B, 3, V). CUDA tensors launch the kernel; CPU
    tensors run `pair_contact_forces_compact_plain`. `counts`, an int32
    tensor of 3 on the card, receives the launch's tile counts added to it
    (evaluated, culled by distance, culled statically; the
    `pair_tile_census_plain` of these inputs with the index row)."""
    if pos.dim() != 3 or pos.shape[1] != 3:
        raise ValueError(f"pos must be (B, 3, V), got {tuple(pos.shape)}")
    B, _, V = pos.shape
    if tuple(scale.shape) != (B, V):
        raise ValueError(f"scale must be (B, V) = {(B, V)}, got {tuple(scale.shape)}")
    S = table.shape[-1] if table.dim() == 3 else 0
    if table.dim() != 3 or table.shape[0] not in (1, B) or table.shape[1] != S + 1 \
            or not 0 < S <= V:
        raise ValueError(f"table must be (B or 1, S + 1, S), 0 < S <= {V}, "
                         f"got {tuple(table.shape)}")
    for name, t in (("pos", pos), ("scale", scale), ("table", table)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")
    if pos.device.type == "cpu":
        if counts is not None:
            raise ValueError("tile counts come from the kernel: pair_tile_census_plain "
                             "computes them on the CPU")
        return pair_contact_forces_compact_plain(pos, scale, table)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    for name, t in (("pos", pos), ("scale", scale), ("table", table)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if counts is not None and (counts.dtype != torch.int32 or tuple(counts.shape) != (3,)
                               or counts.device != pos.device):
        raise ValueError("counts must be an int32 tensor of 3 on the inputs' device")
    if 4 * pair_pass_floats(S) > _SMEM_BYTES:
        raise ValueError(f"S={S} surface voxels overflow the pass's shared memory")
    out = torch.empty_like(pos)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = build.function("pair_contact", "pair_contact_forces_compact",
                        [P, P, P, P, I, I, I, I, ctypes.c_float, P, P])
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(pos.data_ptr(), scale.data_ptr(), table.data_ptr(), out.data_ptr(), B, V, S,
                int(table.shape[0] == B and B > 1), PAIR_CULL_MARGIN,
                counts.data_ptr() if counts is not None else None, stream)
    build.check(rc, "pair_contact_forces_compact")
    global PAIR_CONTACT_COMPACT_LAUNCHES
    PAIR_CONTACT_COMPACT_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# K1: fused forward rollout
# ---------------------------------------------------------------------------

FUSED_ROLLOUT_LAUNCHES = 0
# K1 launches that ran the contact pass (K2's device routine) in their steps
FUSED_ROLLOUT_CONTACT_LAUNCHES = 0
# K1 launches that ran the control-knot channel or the segmented mode
FUSED_ROLLOUT_KNOT_LAUNCHES = 0
# K1 launches of the fluid variants (voxel-face or facet drag), of the
# facet-drag variant alone, and of the development variant
FUSED_ROLLOUT_FLUID_LAUNCHES = 0
FUSED_ROLLOUT_MESH_LAUNCHES = 0
FUSED_ROLLOUT_DEVO_LAUNCHES = 0
# K1 launches that ran the fitness features or tracked sources (the feature
# instance), those of them with ballistic development, those with sources
FUSED_ROLLOUT_FEATURE_LAUNCHES = 0
FUSED_ROLLOUT_BALLISTIC_LAUNCHES = 0
FUSED_ROLLOUT_SOURCE_LAUNCHES = 0
# K1 launches of the material instance, and those of them with the
# material models (nonlinear stress, MDL_DATA tables, plasticity: B6c), the
# solver options (max-velocity clamp, equilibrium mode: B6a), BC regions
# (B6b), the surface-compacted contact pass (B5) and volume effects (B6d)
FUSED_ROLLOUT_MATERIAL_LAUNCHES = 0
FUSED_ROLLOUT_NONLINEAR_LAUNCHES = 0
FUSED_ROLLOUT_SOLVER_LAUNCHES = 0
FUSED_ROLLOUT_BC_LAUNCHES = 0
FUSED_ROLLOUT_COMPACT_LAUNCHES = 0
FUSED_ROLLOUT_VOLUME_LAUNCHES = 0
# K1 launches of the device-memory instances (the robot's buffer in device
# memory: bodies past one block's shared memory, `k1_instance`)
FUSED_ROLLOUT_GMEM_LAUNCHES = 0


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
        scalars["freeze"],
        np.float32(1.0) + np.float32(PAIR_CULL_MARGIN),  # as K2's 1.f + margin
    ]
    return np.asarray(vals, dtype=np.float32)


def equilibrium_scalars(scalars: dict) -> dict:
    """A launch's scalars under equilibrium mode's damping override
    (reference: EnableEquilibriumMode, VX_Sim.cpp:1351-1372)."""
    return dict(scalars, bond_damping_z=0.1, slow_damping_z=0.0)


def _mat_params(scalars: dict) -> np.ndarray:
    """The material instance's float constants (csrc MatArgs): the
    max-velocity clamp's largest displacement a step, max_vox_vel_limit * L
    rounded from the double product as the plain version's tensor of it."""
    return np.asarray([scalars["max_vel_limit"] * scalars["L"]], dtype=np.float32)


def _vol_params(scalars: dict) -> np.ndarray:
    """The volume instance's float constants (csrc VolArgs): DtFrac, 2 pi
    with the reference's truncated pi (VX_Sim.cpp:1725) and L², each the
    float32 rounding of the double the eager step's Python expression
    gives."""
    from evosoro_tpu_torch.core.constants import REF_PI_DOUBLE

    L = scalars["L"]
    return np.asarray([scalars["dt_frac"], 2.0 * REF_PI_DOUBLE, L * L], dtype=np.float32)


def _feat_params(scalars: dict, flags: dict) -> np.ndarray:
    """The features' constants of a launch (csrc FeatParams, N_FEAT_PARAMS
    floats): each the float32 rounding of the double the JAX kernel's Python
    expression gives, then the counts."""
    n_win = int(flags.get("n_win", 0) or 0)
    tb = scalars["tb"]
    mid, freeze = scalars["freeze_middle"], scalars["freeze"]
    src = np.zeros((MAX_KERNEL_SOURCES, 9))
    for k, (bx, by, bz, ax, ay, az, fx, fy, fz) in enumerate(scalars.get("sources", ())):
        src[k] = (bx, by, bz, ax, ay, az, _TWO_PI_VEC3D * fx, _TWO_PI_VEC3D * fy,
                  _TWO_PI_VEC3D * fz)
    vals = [1.0 / scalars["L"], tb, scalars["nexp"], mid - 0.5 * freeze, mid + 0.5 * freeze,
            n_win * tb, 2.0 * (n_win * tb), scalars["min_growth_t"],
            1.0 - scalars["max_slow"], scalars["bal_slow"], *src.ravel(),
            n_win, len(scalars.get("sources", ())), float(scalars["nexp"]) == 1.0]
    return np.asarray(vals, dtype=np.float32)


def _unpack_body(body_packed, grid_shape, L, flags=None) -> VoxelBody:
    """The VoxelBody fields the eager step reads, from packed channels
    (shared bodies come back unbatched); `flags` carry the development
    switches the packed channels do not."""
    flags = flags or {}
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
    # the material fields ride channels the land step does not read
    mat = dict(mat_temp_phase=g(_B_MTPHASE), mat_model_vox=g(_B_MATMODEL),
               plastic_mod=g(_B_PLASTIC), yield_stress=g(_B_YIELD),
               all_linear=not flags.get("nonlinear"))
    kw = {name: per_dir(off, bool if name in ("bond_mask", "bond_homogeneous") else None)
          for name, off in _PER_DIR_FIELDS}
    # volume effects' bond fields, from the sides' moduli and Poisson ratios
    from evosoro_tpu_torch.core.materials import poisson_bond_fields
    from evosoro_tpu_torch.core.step import _nbr

    poisson = g(_B_POISSON)
    bond_u, bond_eh = poisson_bond_fields(
        kw["bond_e1"], kw["bond_e2"], poisson.unsqueeze(-4).expand(kw["bond_e1"].shape),
        torch.stack([_nbr(poisson, d) for d in range(3)], dim=-4))
    return VoxelBody(
        occ=g(_B_OCC) > 0.5, mat=g(_B_MAT).to(torch.int32), nom_pos=nom_pos,
        nominal_size=float(L), mass=g(_B_MASS), mass_inv=g(_B_MASS_INV),
        inertia=torch.where(inertia_inv != 0, 1.0 / torch.where(
            inertia_inv != 0, inertia_inv, 1.0), 0.0),
        inertia_inv=inertia_inv, first_moment=zeros, e_mod=g(_B_EMOD),
        poisson=poisson, cte=g(_B_CTE), u_static=g(_B_US),
        u_dynamic=g(_B_UD), lin_stiffness=g(_B_LIN_STIFF),
        two_sq_mexs=g(_B_2SQ_MEXS), two_sq_iexsss=g(_B_2SQ_IEXSSS),
        phase_offset=g(_B_PHASE), final_phase_offset=g(_B_FINAL_PHASE),
        temp_amp_damp=g(_B_AMPDAMP), final_temp_amp_damp=g(_B_FINAL_AD),
        initial_voxel_size=g(_B_INIT_SIZE), final_voxel_size=g(_B_FINAL_SIZE),
        growth_time=g(_B_GROWTH_T), start_growth_time=g(_B_START_GT),
        using_initial_voxel_size=bool(flags.get("use_init_size")),
        using_final_voxel_size=bool(flags.get("use_final_size")),
        using_growth_time=bool(flags.get("use_growth_t")),
        using_final_phase_offset=bool(flags.get("use_final_phase")),
        using_final_temp_amp_damp=bool(flags.get("use_final_ad")),
        dof_fixed=torch.zeros(lead + (X, Y, Z), dtype=torch.int32, device=dev),
        external_force=zeros[..., None].expand(lead + (X, Y, Z, 3)),
        external_disp=zeros[..., None].expand(lead + (X, Y, Z, 3)),
        external_tdisp=zeros[..., None].expand(lead + (X, Y, Z, 3)),
        bond_e=kw["bond_e"], bond_a1=kw["bond_e"] * Lt, bond_u=bond_u, bond_eh=bond_eh,
        **mat, **{k: v for k, v in kw.items() if k != "bond_e"},
    )


def _with_tables(body: VoxelBody, grid_shape, ss_packed, bc_packed) -> VoxelBody:
    """`body` with the MDL_DATA tables and the BC channels of a launch."""
    X, Y, Z = grid_shape

    def g(t, k):
        t = t[0] if t.shape[0] == 1 else t
        return t[..., k, :].reshape(tuple(t.shape[:-2]) + (X, Y, Z))

    if ss_packed is not None:
        P = (ss_packed.shape[1] - 3) // 2
        body = body.replace(
            ss_strain_vox=torch.stack([g(ss_packed, k) for k in range(P)], dim=-1),
            ss_stress_vox=torch.stack([g(ss_packed, P + k) for k in range(P)], dim=-1),
            ss_fail_strain_vox=g(ss_packed, 2 * P), ss_last_stress_vox=g(ss_packed, 2 * P + 1),
            ss_last_slope_vox=g(ss_packed, 2 * P + 2))
    if bc_packed is not None:
        dof = sum((g(bc_packed, k) > 0.5).to(torch.int32) << k for k in range(6))
        body = body.replace(dof_fixed=dof, **{
            name: torch.stack([g(bc_packed, base + c) for c in range(3)], dim=-1)
            for name, base in (("external_force", 6), ("external_disp", 9),
                               ("external_tdisp", 12))})
    return body


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


# 2 pi with Vec3D's truncated pi, as the JAX kernel writes it
_TWO_PI_VEC3D = 2.0 * REF_PI_VEC3D


class _PlainFeatures:
    """The plain version's feature carry: stats channels 22-46 as (B,)
    tensors and the window ring, kept in the JAX kernel's order of
    operations (_make_kernel:1078-1169 at the top of a step, 1752-1837
    after it)."""

    def __init__(self, stats, body_packed, scalars, flags):
        self.c = {k: stats[:, k].clone() for k in range(_S_SRC, _S_EOLCAP + 1)}
        self.flags, self.sc = flags, scalars
        self.src = scalars.get("sources", ())
        self.n_win = int(flags.get("n_win", 0) or 0)
        self.feat = any(flags.get(k) for k in _K1_FEATURE_FLAGS)
        self.trace = any(flags.get(k) for k in _K1_TRACE_FLAGS)
        self.occ = body_packed[:, _B_OCC] > 0.5
        self.mat = body_packed[:, _B_MAT]
        self.mass = body_packed[:, _B_MASS]
        self.inv_l = 1.0 / scalars["L"]
        zero = torch.zeros_like(stats[:, 0])
        self.ring_y = [zero] * self.n_win
        self.ring_v = [zero] * self.n_win

    def _vol_norm(self, dy, v1, v2):
        avg = 0.5 * (v1 + v2)
        safe = torch.where(avg > 0, avg, 1.0)
        nexp = float(self.sc["nexp"])
        return dy / safe if nexp == 1.0 else dy / safe ** nexp

    def top(self, i, i_glob, state, init_cm, stop_t):
        """Sources, end-of-life posterior Y, needle, fall-over latch from the
        state step i starts from; returns the latch (B,) bool."""
        c, L, t = self.c, self.sc["L"], state.time
        pos = state.pos.flatten(-4, -2)  # (B, V, 3)
        if self.src:
            tau = torch.clamp(t - init_cm, min=0.0)
            hist = i % 50 == 0  # UPDATE_SOURCES_HIST_EVERY
            for k, (bx, by, bz, ax, ay, az, fx, fy, fz) in enumerate(self.src):
                sp = [b + a * torch.sin((_TWO_PI_VEC3D * f) * tau)
                      for b, a, f in ((bx, ax, fx), (by, ay, fy), (bz, az, fz))]
                d = [pos[..., a] - sp[a][:, None] for a in range(3)]
                d2 = torch.where(self.occ, d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 3.4e38)
                # a true division: by a Python number the card multiplies by
                # its reciprocal, which K1 and the JAX kernel do not
                dmin = torch.sqrt(d2.amin(-1))
                c[_S_SRC + k] = dmin / torch.full_like(dmin, L)
                if hist:
                    c[_S_SRC + 3 + k] = c[_S_SRC + 3 + k] + c[_S_SRC + k]
            if hist:
                c[_S_SRC + 6] = c[_S_SRC + 6] + 1.0
        if not self.feat:
            return torch.zeros_like(t, dtype=torch.bool)
        valid = self.occ & ((self.mat - 5.0).abs() > 0.5)
        py = torch.where(valid, pos[..., 1] * self.inv_l, 3.4e38).amin(-1)
        ecap = (c[_S_EOLCAP] < 0.5) & (t >= stop_t)
        c[_S_EOLY] = torch.where(ecap, py, c[_S_EOLY])
        c[_S_EOLCAP] = torch.where(ecap, 1.0, c[_S_EOLCAP])
        if self.flags.get("needle"):
            is7 = torch.where((self.mat - 7.0).abs() < 0.5, 1.0, 0.0)
            n7 = torch.clamp(is7.sum(-1), min=1.0)
            ncapb = (c[_S_NCAP] < 0.5) & (t > init_cm)
            take = ncapb | ((i_glob == 0) & (c[_S_NCAP] < 0.5))
            for a in range(3):
                npos = (is7 * pos[..., a]).sum(-1) / n7
                c[_S_NEEDLE + a] = torch.where(take, npos, c[_S_NEEDLE + a])
            c[_S_NCAP] = torch.where(ncapb, 1.0, c[_S_NCAP])
        if self.flags.get("falling"):
            touch = (0.5 * state.scale.flatten(-3) - pos[..., 2] > 0.0) & self.occ
            n_all = torch.where(touch, 1.0, 0.0).sum(-1)
            feet = touch & ((self.mat - 6.0).abs() < 0.5)
            n_feet = torch.where(feet, 1.0, 0.0).sum(-1)
            c[_S_FELL] = torch.maximum(c[_S_FELL], torch.where(
                (t > init_cm) & (n_feet > n_all - n_feet), 1.0, 0.0))
            return c[_S_FELL] > 0.5
        return torch.zeros_like(t, dtype=torch.bool)

    def after(self, t_new, new, init_cm, inv_m):
        """The trace bookkeeping after a step that ends at t_new with the
        (raw, not yet frozen) state `new`."""
        if not self.trace:
            return
        c, sc = self.c, self.sc
        cmy = (new.pos[..., 1].flatten(-3) * self.mass).sum(-1) * inv_m
        srel = new.scale.flatten(-3) * self.inv_l
        vol = torch.where(self.occ, srel * srel * srel, 0.0).sum(-1)
        due = (t_new > init_cm) & ((c[_S_NTR] < 0.5) | (c[_S_LASTTR] + sc["tb"] <= t_new))
        if self.flags.get("ndbv"):
            addt = due & (c[_S_NTR] > 0.5)
            term = self._vol_norm((cmy - c[_S_PCMY]) * self.inv_l, vol, c[_S_PVOL])
            c[_S_ND] = c[_S_ND] + torch.where(addt, term, 0.0)
            scv = sc["sc_value"]
            reg = (t_new > scv) & (c[_S_LASTTR] > scv)
            c[_S_NDRG] = c[_S_NDRG] + torch.where(addt & reg, term, 0.0)
            if self.flags.get("freeze_on"):
                # the frozen window (core/rollout.py's mask; the missing
                # init_cm offset of its end is the reference's own)
                mid, fr_len = sc["freeze_middle"], sc["freeze"]
                fs, fe = (mid - 0.5 * fr_len) + init_cm, mid + 0.5 * fr_len

                def in_w(tt):
                    return (tt > fs) & (tt < fe)

                c[_S_NDFZ] = c[_S_NDFZ] + torch.where(
                    addt & in_w(t_new) & in_w(c[_S_LASTTR]), term, 0.0)
        n = self.n_win
        if n:
            self.ring_y = [torch.where(due, a, b)
                           for a, b in zip(self.ring_y[1:] + [cmy], self.ring_y)]
            self.ring_v = [torch.where(due, a, b)
                           for a, b in zip(self.ring_v[1:] + [vol], self.ring_v)]
        c[_S_NTR] = c[_S_NTR] + torch.where(due, 1.0, 0.0)
        c[_S_LASTTR] = torch.where(due, t_new, c[_S_LASTTR])
        c[_S_PCMY] = torch.where(due, cmy, c[_S_PCMY])
        c[_S_PVOL] = torch.where(due, vol, c[_S_PVOL])
        if n:
            win_due = (t_new > init_cm) & (
                (c[_S_LASTWIN] < -0.5) | (c[_S_LASTWIN] + n * sc["tb"] <= t_new))
            valid = torch.clamp(c[_S_NTR], max=float(n))
            wd = torch.zeros_like(t_new)
            for k in range(n - 1):
                dyk = (self.ring_y[k + 1] - self.ring_y[k]) * self.inv_l
                tk = self._vol_norm(dyk, self.ring_v[k + 1], self.ring_v[k])
                wd = wd + torch.where(valid >= float(n - k), tk, 0.0)
            c[_S_WPREV] = torch.where(win_due, c[_S_WLAST], c[_S_WPREV])
            c[_S_WLAST] = torch.where(win_due, wd, c[_S_WLAST])
            c[_S_WCNT] = c[_S_WCNT] + torch.where(win_due, 1.0, 0.0)
            c[_S_LASTWIN] = torch.where(win_due, t_new, c[_S_LASTWIN])

    def store(self, out_stats):
        """Write the channels the kernel writes."""
        for k in range(len(self.src)):
            out_stats[:, _S_SRC + k] = self.c[_S_SRC + k]
            out_stats[:, _S_SRC + 3 + k] = self.c[_S_SRC + 3 + k]
        if self.src:
            out_stats[:, _S_SRC + 6] = self.c[_S_SRC + 6]
        if self.feat:
            for k in range(_S_FELL, _S_EOLCAP + 1):
                out_stats[:, k] = self.c[k]


def fused_rollout_plain(state_packed, body_packed, stats, collision_packed=None,
                        *, control_packed=None, seg_base=None, num_steps,
                        grid_shape, scalars, flags, n_knots: int = 0,
                        total_steps=None, prec: Precision = DEFAULT_PRECISION,
                        ss_packed=None, bc_packed=None):
    """Plain version of K1 on the same packed tensors: unpack, loop the
    eager `core.step.sim_step`, keep the stats row's bookkeeping as the
    kernel does (IniCM capture with the seed at global step 0, divergence
    latch, stop-time freeze, the features' carry, the kinetic-energy ring of
    equilibrium mode, under volume effects the dt the stats row carries in
    and out), select each step's control knot by the global step, and
    repack. Returns (state_out, stats_out)."""
    from evosoro_tpu_torch.core.step import freeze_where, sim_step

    check_envelope(flags, scalars)
    seg0, knot_steps = _knot_clock(flags, num_steps, n_knots, control_packed,
                                   seg_base, total_steps)
    X, Y, Z = grid_shape
    B = state_packed.shape[0]
    L = scalars["L"]
    body = _unpack_body(body_packed, grid_shape, L, flags)
    if facet_drag(flags):
        # the gather/scatter form of the facet drag, from tables built on
        # the host out of each body's occupancy
        from evosoro_tpu_torch.envs.drag import build_mesh_drag, build_mesh_drag_batch

        occ = body.occ.cpu().numpy()
        kw = dict(device=state_packed.device, dtype=state_packed.dtype)
        body = body.replace(mesh_drag=build_mesh_drag(occ, **kw) if occ.ndim == 3
                            else build_mesh_drag_batch(occ, **kw))
    body = _with_tables(body, grid_shape, ss_packed, bc_packed)
    if collision_packed is not None:
        table = collision_packed[0] if collision_packed.shape[0] == 1 else collision_packed
        body = body.replace(collision=CompactTable(table) if flags.get("collision_compact")
                            else table)
    # unpack_state fills every packed field, the plastic strain offset and
    # the volume carry included; the rest of the template gives the dtype
    zero = torch.zeros((B, 3, X, Y, Z), dtype=state_packed.dtype,
                       device=state_packed.device)
    volume = bool(flags.get("volume"))
    template = SimState(**{f.name: None for f in dataclasses.fields(SimState)})
    template = template.replace(pos=zero, strain_offset=zero,
                                ts_sum=zero if volume else None)
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
    equilibrium = bool(flags.get("equilibrium"))
    state = state.replace(time=t, diverged=div,
                          ke_history=st[:, _S_KE:_S_KE + 6].clone())
    if volume:  # the first bond pass's dt, and each step's after it
        state = state.replace(cur_dt=dt.clone())

    sim = SimParams(
        bond_damping_z=scalars["bond_damping_z"],
        col_damping_z=scalars["col_damping_z"],
        slow_damping_z=scalars["slow_damping_z"],
        stop_condition_value=scalars["sc_value"],
        dt_frac=scalars["dt_frac"],
        init_cm_time=init_cm,
        min_temp_fact=st[:, _S_MINTF],
        mid_life_freeze_time=scalars["freeze"],
        max_vox_vel_limit=scalars["max_vel_limit"],
        self_collisions_enabled=bool(flags.get("collision")),
        plasticity_enabled=bool(flags.get("plasticity")),
        max_velocity_enabled=bool(flags.get("max_vel")),
        equilibrium_mode=equilibrium,
        volume_effects_enabled=volume,
    )
    env = EnvParams(
        grav_acc=st[:, _S_GRAV], temp_amplitude=st[:, _S_TAMP],
        temp_period=st[:, _S_TPER], growth_amplitude=st[:, _S_GAMP],
        aggregate_drag_coefficient=st[:, _S_DRAGC],
        gravity_enabled=bool(flags.get("gravity")),
        floor_enabled=bool(flags.get("floor")),
        sticky_floor=bool(flags.get("sticky")),
        temp_enabled=bool(flags.get("temp_enabled") if flags.get("fluid")
                          else flags.get("temp")),
        fluid_environment=bool(flags.get("fluid")),
        num_trace_steps_in_window=int(flags.get("n_win", 0) or 0),
        time_between_traces=scalars["tb"],
        normalization_exponent=scalars["nexp"],
        min_growth_time=scalars["min_growth_t"],
        ballistic_slowdown_fact=scalars["bal_slow"],
        max_slowdown_permitted=scalars["max_slow"],
    )
    feats = _PlainFeatures(stats, body_packed, scalars, flags)
    ballistic = bool(flags.get("ballistic"))
    if ballistic:
        # the rebased development fields ride state channels 56-59
        state = state.replace(devo=DevoState(
            **{name: state_packed[:, _DEVO_DYN + k].reshape(B, X, Y, Z)
               for k, name in enumerate(_DEVO_DYN_FIELDS)},
            original_final_voxel_size=body.final_voxel_size.expand(B, X, Y, Z),
            win_prev=None, win_last=None, win_count=None))
    mass = body.mass
    for i in range(num_steps):
        i_glob = seg0 + i
        cm = (state.pos * mass[..., None]).flatten(-4, -2).sum(-2) * inv_m[:, None]
        capture = ~capt & (state.time > init_cm)
        take = capture | ((i_glob == 0) & ~capt)
        ini = torch.where(take[:, None], cm, ini)
        capt = capt | capture
        fell = feats.top(i, i_glob, state, init_cm, stop_t)
        frozen = state.diverged | (state.time >= stop_t) | fell
        ctrl = None
        if n_knots:
            knot = min(i_glob * n_knots // knot_steps, n_knots - 1)
            ctrl = control_packed[:, knot].reshape(B, X, Y, Z)
        if ballistic:
            c = feats.c
            state = state.replace(devo=state.devo.replace(
                win_prev=c[_S_WPREV], win_last=c[_S_WLAST], win_count=c[_S_WCNT]))
        if feats.trace:
            # the trace samples the step a frozen robot throws away, as the
            # JAX kernel does: integrate it without the divergence freeze
            new = sim_step(state.replace(diverged=torch.zeros_like(state.diverged)), body,
                           sim, env, dt, prec, control_offset=ctrl)
            feats.after(new.time, new, init_cm, inv_m)
        else:
            new = sim_step(state, body, sim, env, dt, prec, control_offset=ctrl)
        state = freeze_where(frozen, state, new)

    out_state = pack_state(state, state_packed.dtype)
    out_stats = stats.clone()
    out_stats[:, _S_TIME] = state.time
    out_stats[:, _S_DIV] = state.diverged.to(stats.dtype)
    out_stats[:, _S_INICM:_S_INICM + 3] = ini
    out_stats[:, _S_CAPT] = capt.to(stats.dtype)
    if equilibrium:
        out_stats[:, _S_KE:_S_KE + 6] = state.ke_history
    if volume:
        out_stats[:, _S_DT] = state.cur_dt
    feats.store(out_stats)
    # channels the kernel never writes keep their input values
    for written, (lo, hi) in ((volume, (_TSAVG, _SOFF)),
                              (flags.get("plasticity"), (_SOFF, _DEVO_DYN)),
                              (ballistic, (_DEVO_DYN, C_S))):
        if not written:
            out_state[:, lo:hi] = state_packed[:, lo:hi]
    return out_state, out_stats


def fused_call(state_packed, body_packed, stats, collision_packed=None, *,
               control_packed=None, seg_base=None, num_steps: int, grid_shape,
               scalars: dict, flags: dict, n_knots: int = 0, total_steps=None,
               prec: Precision = DEFAULT_PRECISION, ss_packed=None, bc_packed=None):
    """K1 wrapper, the counterpart of the JAX package's `_fused_call`.

    state (B, C_S, V), body (B or 1, C_B, V), stats (B, C_STAT), the
    optional pair table (B or 1, V, V), or (B or 1, S + 1, S) compacted
    with flags["collision_compact"] (`pack_collision_compact`), the
    optional controls (B, n_knots, V), and with flags["mdl_data"] the
    MDL_DATA tables (B or 1, 2P + 3, V) (`pack_ss_tables`), with flags["bc"]
    the BC channels (B or 1, 15, V) (`pack_bc_tables`), all float32 on one
    device (or all float64 on the CPU, where the plain version runs). Under
    flags["equilibrium"] the launch takes the mode's damping
    override (`equilibrium_scalars`) and the kinetic-energy ring rides
    stats channels 16-21; with plasticity the strain offset rides state
    channels 53-55. Under flags["volume"] the coupling carry rides state
    channels 47-52 and the stats row's dt is the first bond pass's dt in and
    the last step's out. Step i of the launch is the
    global step `seg_base + i` (`seg_base` an int, given exactly when
    flags["segmented"] is set); its knot is
    `min(global step * n_knots // knot_steps, n_knots - 1)` with
    `knot_steps = total_steps or num_steps`. Returns (state_out, stats_out).
    CUDA tensors launch K1; CPU tensors run `fused_rollout_plain`. Flags
    outside the envelope raise first. With the facet drag the grid must
    carry the corner shell (`has_corner_shell`): `launch_flags` and the
    evaluator check it once, where the launch is put together.

    The features' carry rides stats channels 22-46 in and out, but the
    speed-window ring of trace samples starts empty in every launch, as in
    the JAX kernel: the windows are those of a rollout made in one launch
    (the evaluator's), not of one split into segments. Under ballistic
    development state channels 56-59 carry the rebased fields.

    Every instance has a twin that keeps the robot's buffer in device
    memory, which runs where one block's shared memory does not hold the
    body (`k1_instance`). Both compute the same bits.
    """
    check_envelope(flags, scalars)
    if flags.get("equilibrium"):
        scalars = equilibrium_scalars(scalars)
    seg0, knot_steps = _knot_clock(flags, num_steps, n_knots, control_packed,
                                   seg_base, total_steps)
    X, Y, Z = grid_shape
    V = X * Y * Z
    B = state_packed.shape[0]
    coll = bool(flags.get("collision"))
    compact = bool(flags.get("collision_compact"))
    if coll != (collision_packed is not None):
        raise ValueError("flags['collision'] and the pair table disagree")
    if compact and not coll:
        raise ValueError("flags['collision_compact'] needs flags['collision']")
    for flag, t in (("mdl_data", ss_packed), ("bc", bc_packed)):
        if bool(flags.get(flag)) != (t is not None):
            raise ValueError(f"flags['{flag}'] and its tables disagree")
    shapes = [("state", state_packed, (B, C_S, V)), ("stats", stats, (B, C_STAT))]
    if tuple(body_packed.shape[1:]) != (C_B, V) or body_packed.shape[0] not in (1, B):
        raise ValueError(f"body must be (B or 1, {C_B}, {V}), got {tuple(body_packed.shape)}")
    n_surf = collision_packed.shape[-1] if compact else None
    table_shape = (n_surf + 1, n_surf) if compact else (V, V)
    if coll and (collision_packed.dim() != 3 or collision_packed.shape[0] not in (1, B)
                 or tuple(collision_packed.shape[1:]) != table_shape):
        raise ValueError(f"pair table must be (B or 1, {table_shape[0]}, {table_shape[1]}), "
                         f"got {tuple(collision_packed.shape)}")
    n_pts = 0
    if ss_packed is not None:
        n_pts = (ss_packed.shape[1] - 3) // 2
        if ss_packed.dim() != 3 or ss_packed.shape[0] not in (1, B) or n_pts < 2 \
                or tuple(ss_packed.shape[1:]) != (2 * n_pts + 3, V):
            raise ValueError(f"MDL_DATA tables must be (B or 1, 2P + 3, {V}), P >= 2, got "
                             f"{tuple(ss_packed.shape)}")
    if bc_packed is not None and (bc_packed.dim() != 3 or bc_packed.shape[0] not in (1, B)
                                  or tuple(bc_packed.shape[1:]) != (15, V)):
        raise ValueError(f"BC channels must be (B or 1, 15, {V}), got "
                         f"{tuple(bc_packed.shape)}")
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
    for name, t in (("MDL_DATA tables", ss_packed), ("BC channels", bc_packed)):
        if t is not None:
            tensors.append((name, t))
    on_cpu = state_packed.device.type == "cpu"
    dtype = state_packed.dtype if on_cpu and state_packed.dtype == torch.float64 \
        else torch.float32
    for name, t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != state_packed.device:
            raise ValueError(f"{name} is on {t.device}, state on {state_packed.device}")
    if on_cpu:
        return fused_rollout_plain(
            state_packed, body_packed, stats, collision_packed,
            control_packed=control_packed, seg_base=seg_base,
            num_steps=num_steps, grid_shape=grid_shape, scalars=scalars,
            flags=flags, n_knots=n_knots, total_steps=total_steps, prec=prec,
            ss_packed=ss_packed, bc_packed=bc_packed)
    if state_packed.device.type != "cuda":
        raise ValueError(f"unsupported device {state_packed.device}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    gmem = k1_instance(V, coll, n_surf) == "device"
    # (the instances without a resident half ignore it: csrc/fused_rollout.cu)
    resident = not gmem and k1_resident(V, coll, n_surf)
    bits = _flag_bits(flags)
    mesh = bool(bits & _K1_FLAG_BITS["fluid_mesh"])
    vol = bool(bits & _K1_FLAG_BITS["volume"])
    params = _k1_params(scalars, prec)
    fparams = _feat_params(scalars, flags)
    mparams = _mat_params(scalars)
    state_out = state_packed.clone()
    stats_out = stats.clone()
    # the facet-drag variant leaves each bond's per-side strains here
    scratch = torch.empty((B, _K1_MESH_SCRATCH, V), dtype=torch.float32,
                          device=state_packed.device) if mesh else None
    # the volume instance's bond strains and voxel-pass sums
    vscratch = torch.empty((B, _K1_VOL_SCRATCH, V), dtype=torch.float32,
                           device=state_packed.device) if vol else None
    vparams = _vol_params(scalars) if vol else None
    gbuf = _bond_buffer(B, k1_buffer_floats(V, coll, n_surf), state_packed.device) \
        if gmem else None
    fn = build.library("fused_rollout")
    first = (state_out.data_ptr(), body_packed.data_ptr(),
             int(body_packed.shape[0] == B and B > 1), stats_out.data_ptr(),
             collision_packed.data_ptr() if coll else None,
             int(coll and collision_packed.shape[0] == B and B > 1),
             control_packed.data_ptr() if n_knots else None, int(n_knots),
             knot_steps, seg0, B, X, Y, Z, int(num_steps),
             params.ctypes.data_as(ctypes.c_void_p), bits)
    tables = (ss_packed.data_ptr() if n_pts else None,
              int(n_pts > 0 and ss_packed.shape[0] == B and B > 1), n_pts,
              bc_packed.data_ptr() if bc_packed is not None else None,
              int(bc_packed is not None and bc_packed.shape[0] == B and B > 1),
              int(n_surf or 0), mparams.ctypes.data_as(ctypes.c_void_p))
    with torch.cuda.device(state_packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*first, scratch.data_ptr() if mesh else None,
                fparams.ctypes.data_as(ctypes.c_void_p), *tables,
                vscratch.data_ptr() if vol else None,
                vparams.ctypes.data_as(ctypes.c_void_p) if vol else None,
                gbuf.data_ptr() if gmem else None, gbuf.stride(0) if gmem else 0,
                int(resident), stream)
    build.check(rc, "fused_rollout")
    global FUSED_ROLLOUT_LAUNCHES, FUSED_ROLLOUT_CONTACT_LAUNCHES
    global FUSED_ROLLOUT_KNOT_LAUNCHES, FUSED_ROLLOUT_FLUID_LAUNCHES
    global FUSED_ROLLOUT_MESH_LAUNCHES, FUSED_ROLLOUT_DEVO_LAUNCHES
    global FUSED_ROLLOUT_FEATURE_LAUNCHES, FUSED_ROLLOUT_BALLISTIC_LAUNCHES
    global FUSED_ROLLOUT_SOURCE_LAUNCHES, FUSED_ROLLOUT_MATERIAL_LAUNCHES
    global FUSED_ROLLOUT_NONLINEAR_LAUNCHES, FUSED_ROLLOUT_SOLVER_LAUNCHES
    global FUSED_ROLLOUT_BC_LAUNCHES, FUSED_ROLLOUT_COMPACT_LAUNCHES
    global FUSED_ROLLOUT_VOLUME_LAUNCHES, FUSED_ROLLOUT_GMEM_LAUNCHES
    FUSED_ROLLOUT_LAUNCHES += 1
    if gmem:
        FUSED_ROLLOUT_GMEM_LAUNCHES += 1
    if any(bits & _K1_FLAG_BITS[k] for k in _K1_MAT_FLAGS):
        FUSED_ROLLOUT_MATERIAL_LAUNCHES += 1
    if any(bits & _K1_FLAG_BITS[k] for k in ("nonlinear", "mdl_data", "plasticity")):
        FUSED_ROLLOUT_NONLINEAR_LAUNCHES += 1
    if any(bits & _K1_FLAG_BITS[k] for k in ("max_vel", "equilibrium")):
        FUSED_ROLLOUT_SOLVER_LAUNCHES += 1
    if bits & _K1_FLAG_BITS["bc"]:
        FUSED_ROLLOUT_BC_LAUNCHES += 1
    if compact:
        FUSED_ROLLOUT_COMPACT_LAUNCHES += 1
    if vol:
        FUSED_ROLLOUT_VOLUME_LAUNCHES += 1
    if any(flags.get(k) for k in _K1_FEATURE_FLAGS) or scalars.get("sources"):
        FUSED_ROLLOUT_FEATURE_LAUNCHES += 1
    if scalars.get("sources"):
        FUSED_ROLLOUT_SOURCE_LAUNCHES += 1
    if flags.get("ballistic"):
        FUSED_ROLLOUT_BALLISTIC_LAUNCHES += 1
    if bits & _K1_FLAG_BITS["fluid"]:
        FUSED_ROLLOUT_FLUID_LAUNCHES += 1
    if mesh:
        FUSED_ROLLOUT_MESH_LAUNCHES += 1
    if any(bits & _K1_FLAG_BITS[k] for k in _K1_DEVO_FLAGS):
        FUSED_ROLLOUT_DEVO_LAUNCHES += 1
    if coll:
        FUSED_ROLLOUT_CONTACT_LAUNCHES += 1
    if n_knots or flags.get("segmented"):
        FUSED_ROLLOUT_KNOT_LAUNCHES += 1
    return state_out, stats_out


# ---------------------------------------------------------------------------
# B4: reverse-mode segment
# ---------------------------------------------------------------------------

FUSED_BWD_LAUNCHES = 0
# ... of them in water (either drag model), with the facet drag, with the
# development ramps
FUSED_BWD_FLUID_LAUNCHES = 0
FUSED_BWD_MESH_LAUNCHES = 0
FUSED_BWD_DEVO_LAUNCHES = 0
# ... of its device-memory instance (`b4_launch_shape`)
FUSED_BWD_GMEM_LAUNCHES = 0
# ... of its material instance (nonlinear stress, the max-velocity clamp)
FUSED_BWD_MATERIAL_LAUNCHES = 0

# channels [0, _TSAVG) carry the rollout and its cotangent; B4's tape holds
# them plus one channel of static-friction decisions (csrc: NT), and with
# the facet drag each step's six per-side bond strains (NT_MESH)
_B4_TAPE_CHANNELS = _TSAVG + 1
_B4_MESH_TAPE_CHANNELS = _B4_TAPE_CHANNELS + _K1_MESH_SCRATCH
# device scratch of B4's facet-drag variant, floats a voxel (csrc: B4_MESH_SCR)
_B4_MESH_SCRATCH = 27
# flags outside the reverse-mode kernel's envelope (the JAX package's
# `_diff_envelope_ok`), each with the reason; the rest of `check_envelope`
# applies as well. Nonlinear materials and the max-velocity clamp run in
# B4's material instance of every variant
_DIFF_REFUSED = dict(
    volume="volume effects", equilibrium="equilibrium mode", plasticity="plasticity",
    needle="the needle feature", falling="the fall-over latch",
    ndbv="NormDistByVol", window="speed windows", ballistic="ballistic development",
    collision="self-collision", collision_compact="the compact contact pass",
    mdl_data="MDL_DATA materials", bc="BC regions")


def _diff_refusal(flags, scalars):
    """The name of the first thing of a launch outside B4's envelope, or None."""
    f = dict(flags)
    for k, why in _DIFF_REFUSED.items():
        if f.get(k):
            return f"'{k}' ({why})"
    if len(dict(scalars).get("sources", ())) != 0:
        return "'sources' (environmental sources)"
    return None


def diff_envelope_ok(flags, scalars) -> bool:
    """True when the reverse-mode segment kernel covers the launch: the MPC
    control envelope on land, in water (voxel-face or facet drag) and with
    the development ramps, each also with bilinear materials and the
    max-velocity clamp (B4's material instance of the variant); without
    collision, volume effects, sources, fitness features, MDL_DATA
    materials, plasticity, equilibrium mode or BC regions."""
    return _diff_refusal(flags, scalars) is None


@functools.lru_cache(maxsize=256)
def _b4_shape(B, X, Y, Z, bits, gmem, cluster, device):
    """`fused_rollout_bwd_shape`'s out[8] on card `device`: a solver asks
    for the same few shapes again and again, and each answer costs the C
    entry several occupancy queries."""
    out = (ctypes.c_int * 8)()
    shape = build.function("fused_rollout_bwd", "fused_rollout_bwd_shape",
                           [ctypes.c_int] * 7 + [ctypes.c_void_p])
    with torch.cuda.device(device):
        build.check(shape(B, X, Y, Z, bits, int(gmem), cluster,
                          ctypes.cast(out, ctypes.c_void_p)), "fused_rollout_bwd_shape")
    return tuple(out)


def b4_launch_shape(B: int, grid_shape, flags: dict, cluster: int = 0) -> dict:
    """How B4 runs B robots on this grid on the current card, as its C
    entry decides it (csrc/fused_rollout_bwd.cu `b4_shape`, asked of the
    built library: this needs the CUDA toolkit): `cluster` blocks a robot
    (a thread-block cluster, as many as let the card hold all B at once;
    `cluster` > 0 asks for that many), each owning `planes` x-planes,
    `threads` a block, `slab` floats of a block's reverse sweep, `smem`
    bytes of dynamic shared memory a block, `clusters_at_once` the clusters
    of that shape the card holds at once; the `instance`, "shared" where
    one block's shared memory holds the recompute's buffer (K1's without
    contact, `k1_instance`), else "device" (`buffer_floats` a robot in
    device memory); `slabs`, "shared" or "device" (`slab_floats` a robot)."""
    X, Y, Z = grid_shape
    instance = k1_instance(X * Y * Z, False)
    C, threads, planes, slab, buffer_floats, slab_floats, smem, at_once = _b4_shape(
        B, X, Y, Z, _flag_bits(flags), instance == "device", cluster,
        torch.cuda.current_device())
    return dict(cluster=C, threads=threads, planes=planes, slab=slab, smem=smem,
                clusters_at_once=at_once, instance=instance, buffer_floats=buffer_floats,
                slabs="device" if slab_floats else "shared", slab_floats=slab_floats)


def b4_tape_channels(flags) -> int:
    """Channels of a slot of B4's tape for a launch with these flags."""
    return _B4_MESH_TAPE_CHANNELS if facet_drag(flags) else _B4_TAPE_CHANNELS


def _check_bwd(flags, scalars, n_knots, seg_base, total_steps):
    why = _diff_refusal(flags, scalars)
    if why is not None:
        raise NotImplementedError(
            f"reverse-mode segment: {why} is outside the differentiable "
            "envelope (ops.fused_rollout.diff_envelope_ok)")
    check_envelope(flags, scalars)
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
    `fused_bwd_plain`. Flags outside `diff_envelope_ok` raise first. With
    nonlinear materials or the max-velocity clamp the material instance
    runs, whose recompute is K1's material instance. Each robot runs on a
    cluster of blocks, and past one block's shared memory the device-memory
    instance runs (`b4_launch_shape`)."""
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
    with torch.cuda.device(state_packed.device):
        shape = b4_launch_shape(B, grid_shape, flags)
    gmem = shape["instance"] == "device"
    bits = _flag_bits(flags)
    params = _k1_params(scalars, prec)
    S = int(num_steps)
    dev = state_packed.device
    # scratch of the launch: the forward recompute's tape and step clocks,
    # and the facet drag's vertex field and corner cotangents
    tape = torch.empty((B, S + 1, b4_tape_channels(flags), V), dtype=torch.float32,
                       device=dev)
    tape_t = torch.empty((B, max(S, 1)), dtype=torch.float32, device=dev)
    mesh = bool(bits & _K1_FLAG_BITS["fluid_mesh"])
    scratch = torch.empty((B, _B4_MESH_SCRATCH, V), dtype=torch.float32,
                          device=dev) if mesh else None
    cot = cot_state.clone()  # pulled back in place
    cot_ctrl = torch.zeros_like(control_packed)
    gbuf = _bond_buffer(B, shape["buffer_floats"], dev) if gmem else None
    sbuf = torch.empty((B, shape["slab_floats"]), dtype=torch.float32,
                       device=dev) if shape["slab_floats"] else None
    mparams = _mat_params(scalars)
    fn = build.library("fused_rollout_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(state_packed.data_ptr(), body_packed.data_ptr(),
                int(body_packed.shape[0] == B and B > 1), stats.data_ptr(),
                control_packed.data_ptr(), int(n_knots), knot_steps, seg0,
                B, X, Y, Z, S, params.ctypes.data_as(ctypes.c_void_p), bits,
                tape.data_ptr(), tape_t.data_ptr(), cot.data_ptr(),
                cot_ctrl.data_ptr(), scratch.data_ptr() if mesh else None,
                mparams.ctypes.data_as(ctypes.c_void_p),
                gbuf.data_ptr() if gmem else None, gbuf.stride(0) if gmem else 0,
                sbuf.data_ptr() if sbuf is not None else None, shape["cluster"], stream)
    build.check(rc, "fused_rollout_bwd")
    global FUSED_BWD_LAUNCHES, FUSED_BWD_FLUID_LAUNCHES, FUSED_BWD_MESH_LAUNCHES
    global FUSED_BWD_DEVO_LAUNCHES, FUSED_BWD_GMEM_LAUNCHES, FUSED_BWD_MATERIAL_LAUNCHES
    FUSED_BWD_LAUNCHES += 1
    if gmem:
        FUSED_BWD_GMEM_LAUNCHES += 1
    if bits & (_K1_FLAG_BITS["nonlinear"] | _K1_FLAG_BITS["max_vel"]):
        FUSED_BWD_MATERIAL_LAUNCHES += 1
    if bits & _K1_FLAG_BITS["fluid"]:
        FUSED_BWD_FLUID_LAUNCHES += 1
    if mesh:
        FUSED_BWD_MESH_LAUNCHES += 1
    if any(bits & _K1_FLAG_BITS[k] for k in _K1_DEVO_FLAGS):
        FUSED_BWD_DEVO_LAUNCHES += 1
    return cot, cot_ctrl


def fused_rollout(state: SimState, body: VoxelBody, sim: SimParams,
                  env: EnvParams, num_steps: int, dt, stop_time=None,
                  prec: Precision = DEFAULT_PRECISION, stats=None,
                  control_sequence=None, stop_condition_type=None):
    """Advance a batched SimState by `num_steps` through `fused_call` for one
    shared design; `control_sequence` is the optional (B, K, X, Y, Z) MPC
    knot channel. A state that carries a DevoState runs ballistic
    development under the environment's speed windows; the body's MDL_DATA
    tables and BC regions ride along, equilibrium mode takes its damping
    override and its kinetic-energy ring from `state.ke_history`. With
    `EVOSORO_TPU_COLL_COMPACT=1` in the environment the contact pass runs
    surface-compacted (as the JAX package's switch, but whenever the surface
    has fewer voxels than the grid: S < V, where the JAX package compares
    counts padded to 128 lanes). Under volume effects the state must carry
    the coupling carry (`init_state(volume_effects=True)`); its `cur_dt`, where
    positive, is the first bond pass's dt, and the new state's is the last
    step's. The stop condition is max sim time (through
    `stop_time`): the other types run on the eager rollout only
    (`core.rollout`). A float64 state on the CPU runs the plain version in
    float64. Returns (new_state, FastRolloutStats), with the sources'
    distances when the environment has sources."""
    from evosoro_tpu_torch.core.types import SC_MAX_SIM_TIME

    if stop_condition_type not in (None, SC_MAX_SIM_TIME):
        raise NotImplementedError(
            f"fused rollout: stop condition type {stop_condition_type} runs on the "
            "eager rollout only (core.rollout.rollout)")
    if not supports(body, sim, env):
        raise NotImplementedError(
            "configuration outside the fused rollout's envelope "
            "(ops.fused_rollout.supports)")
    if sim.volume_effects_enabled and state.ts_sum is None:
        raise ValueError("volume effects enabled but the state has no coupling carry; "
                         "create it with init_state(body, volume_effects=True)")
    args, kw = launch_inputs(state, body, sim, env, dt, stop_time, stats, control_sequence)
    out_state, out_stats = fused_call(*args, num_steps=num_steps, prec=prec, **kw)
    return launch_outputs(out_state, out_stats, state, body, sim, env)


def launch_outputs(out_state, out_stats, state: SimState, body: VoxelBody, sim: SimParams,
                   env: EnvParams):
    """(new_state, FastRolloutStats) of a `launch_inputs` launch that started
    from the batched `state`."""
    X, Y, Z = body.occ.shape[-3:]
    outs = stats_to_outputs(out_stats)
    new_state = unpack_state(out_state, state, (X, Y, Z)).replace(
        time=outs.time.to(state.time.dtype), diverged=outs.diverged)
    if sim.equilibrium_mode:
        new_state = new_state.replace(
            ke_history=out_stats[:, _S_KE:_S_KE + 6].to(state.ke_history.dtype))
    if sim.volume_effects_enabled and state.cur_dt is not None:
        new_state = new_state.replace(cur_dt=out_stats[:, _S_DT].to(state.cur_dt.dtype))
    n_src = len(kernel_scalars(body.nominal_size, sim, env)["sources"])
    if n_src:
        cnt = out_stats[:, _S_SRC + 6:_S_SRC + 7]
        outs = dataclasses.replace(
            outs, source_min_dist=out_stats[:, _S_SRC:_S_SRC + n_src],
            source_avg_min_dist=torch.where(
                cnt > 0, out_stats[:, _S_SRC + 3:_S_SRC + 3 + n_src]
                / torch.where(cnt > 0, cnt, 1.0), -1.0))
    if new_state.devo is not None:
        dtype = state.devo.win_last.dtype
        new_state = new_state.replace(devo=new_state.devo.replace(
            win_last=out_stats[:, _S_WLAST].to(dtype),
            win_prev=out_stats[:, _S_WPREV].to(dtype),
            win_count=out_stats[:, _S_WCNT].to(torch.int32)))
    return new_state, outs


def launch_inputs(state: SimState, body: VoxelBody, sim: SimParams, env: EnvParams, dt,
                  stop_time=None, stats=None, control_sequence=None, **extra_flags):
    """`fused_rollout`'s K1 launch for a batched state and one design, as
    (args, kw) for `fused_call(*args, num_steps=..., **kw)`: the packed
    state, body, stats row and pair table, then the grid, scalars, flags,
    controls and tables. `extra_flags` join the launch's flags (`segmented`,
    which then needs `seg_base` and `total_steps` in the call). Packed in
    float32, as the kernels take it; a float64 state on the CPU packs in
    float64, for the plain version."""
    import os

    from evosoro_tpu_torch.core.step import has_bc

    X, Y, Z = body.occ.shape[-3:]
    B = state.scale.shape[0]
    dtype = torch.float64 if state.pos.device.type == "cpu" \
        and state.pos.dtype == torch.float64 else torch.float32
    state_packed = pack_state(state, dtype)
    body_packed = pack_body(body, dtype)
    dev = state_packed.device
    collision_packed, compact = None, False
    if sim.self_collisions_enabled and body.collision is not None:
        n_surf = int(np.asarray(body.collision.surf_mask).sum())
        compact = os.environ.get("EVOSORO_TPU_COLL_COMPACT") == "1" and n_surf < X * Y * Z
        pack = pack_collision_compact if compact else pack_collision
        collision_packed = torch.as_tensor(pack(body.collision, (X, Y, Z)), device=dev,
                                           dtype=dtype)[None]
    ss_packed = pack_ss_tables(body, dtype).to(dev) if body.ss_strain_vox is not None else None
    bc_packed = pack_bc_tables(body, dtype).to(dev) if has_bc(body) else None
    if stats is None:
        stats = _carried_dt(make_stats(body, B, dt, sim, env, stop_time, dtype), state, sim)
    if sim.equilibrium_mode and state.ke_history is not None:
        stats = stats.clone()
        stats[:, _S_KE:_S_KE + 6] = state.ke_history.to(stats.dtype)
    flags = launch_flags(body, sim, env, collision=collision_packed is not None,
                         collision_compact=compact, ballistic=_ballistic(state, env),
                         **extra_flags)
    n_knots, control_packed = 0, None
    if control_sequence is not None:
        n_knots = control_sequence.shape[1]
        control_packed = _flat(control_sequence.to(dtype), (B, n_knots)).contiguous()
    return (state_packed, body_packed, stats, collision_packed), dict(
        control_packed=control_packed, grid_shape=(X, Y, Z),
        scalars=kernel_scalars(body.nominal_size, sim, env), flags=flags,
        n_knots=n_knots, ss_packed=ss_packed, bc_packed=bc_packed)


def _carried_dt(stats, state: SimState, sim: SimParams):
    """`stats` with the state's carried dt, where positive, as the first
    bond pass's dt of a volume-effects launch (the eager step's rule)."""
    if sim.volume_effects_enabled and state.cur_dt is not None:
        cur = state.cur_dt.to(stats.dtype).expand(stats.shape[0])
        stats[:, _S_DT] = torch.where(cur > 0, cur, stats[:, _S_DT])
    return stats


def _ballistic(state: SimState, env: EnvParams) -> bool:
    """Ballistic development runs when the state carries a DevoState and the
    environment defines speed windows (the JAX package's rule)."""
    return state.devo is not None and int(env.num_trace_steps_in_window) > 0


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
            dt = calc_max_dt(body, sim.volume_effects_enabled) * sim.dt_frac
        if state is None:
            state = init_state(body, volume_effects=sim.volume_effects_enabled)
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
        self.stats = _carried_dt(make_stats(body, batch, dt, sim, env, stop_time), state, sim)
        from evosoro_tpu_torch.core.step import has_bc

        dev = self.state_packed.device
        self.call_kwargs = dict(
            num_steps=num_steps, grid_shape=self.grid_shape,
            scalars=kernel_scalars(body.nominal_size, sim, env),
            flags=launch_flags(body, sim, env,
                               collision=self.collision_packed is not None,
                               ballistic=_ballistic(state, env)),
            n_knots=num_knots, prec=prec,
            ss_packed=pack_ss_tables(body).to(dev) if body.ss_strain_vox is not None else None,
            bc_packed=pack_bc_tables(body).to(dev) if has_bc(body) else None)

    def run(self, controls):
        """controls (B, K, X, Y, Z) -> `packed_metrics` of every candidate."""
        ctrl = _flat(controls.to(torch.float32),
                     (self.batch, self.num_knots)).contiguous()
        out_state, out_stats = fused_call(
            self.state_packed, self.body_packed, self.stats,
            self.collision_packed, control_packed=ctrl, **self.call_kwargs)
        return packed_metrics(out_state, self.body_packed, out_stats, self.L)
