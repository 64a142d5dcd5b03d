"""One physics timestep over the dense voxel lattice, eager torch.

The port of `evosoro_tpu.core.step.sim_step` (reference call stack:
VX_Sim.cpp:1054 TimeStep -> 1763 Integrate -> VXS_BondInternal.cpp:56
CalcLinForce -> VXS_Voxel.cpp:169 EulerStep). Everything is dense
`(..., X, Y, Z)` tensors with an optional leading batch shape; bonds live
on the 3 positive lattice directions and each voxel gathers its 6
neighbour contributions by shifted reads. Every branch of the reference is
a `torch.where` selection, as in the JAX step.

This is the port's own CPU reference and the plain version of the fused
rollout kernel. It covers the evolution loop's envelope: linear materials,
beam bonds with small/large-angle hysteresis and bond damping, slow
damping, self-collision, gravity, floor contact with Coulomb friction and
the sticky floor, Euler and angular integration, and thermal actuation with
the mid-life freeze. Every other feature raises NotImplementedError.
"""

from __future__ import annotations

import torch

from evosoro_tpu_torch.core import quaternion as q
from evosoro_tpu_torch.core.collision import CollisionSystem, collision_forces
from evosoro_tpu_torch.core.constants import (
    DEFAULT_PRECISION,
    DIVERGENCE_STRAIN,
    HYSTERESIS_FACTOR,
    REF_PI_FLOAT,
    SA_BOND_EXT_PERC,
    Precision,
)
from evosoro_tpu_torch.core.types import EnvParams, SimParams, SimState, VoxelBody


def _safe_div(a, b):
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, 1.0), 0.0)


def _safe_norm(*components):
    sq = components[0] * components[0]
    for c in components[1:]:
        sq = sq + c * c
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, 1.0)), 0.0)


def _vox(s):
    """A per-robot scalar (float, or tensor of the batch shape) broadcast
    against (..., X, Y, Z) tensors."""
    if torch.is_tensor(s) and s.dim() > 0:
        return s[..., None, None, None]
    return s


def _vec(s):
    """A per-robot scalar broadcast against (..., X, Y, Z, 3) tensors."""
    if torch.is_tensor(s) and s.dim() > 0:
        return s[..., None, None, None, None]
    return s


def _f32(v, like):
    """A Python or tensor scalar rounded through float32 (the reference
    stores TempAmplitude/TempPeriod as float members, VXS_Voxel.h:109-110)."""
    return torch.as_tensor(v, device=like.device).to(torch.float32).to(like.dtype)


# ---------------------------------------------------------------------------
# Axis-frame permutations (reference: VX_Bond.h:45-48 ToXDirBond/ToOrigDirBond)
# ---------------------------------------------------------------------------

def _to_x_vec(d, v):
    """Rotate a vector so bond axis d looks like +X (90° lattice rotation)."""
    if d == 0:
        return v
    x, y, z = v.unbind(-1)
    if d == 1:  # AXIS_Y: new = (y, -x, z)
        return torch.stack([y, -x, z], dim=-1)
    return torch.stack([z, y, -x], dim=-1)  # AXIS_Z: new = (z, y, -x)


def _to_orig_vec(d, v):
    if d == 0:
        return v
    x, y, z = v.unbind(-1)
    if d == 1:
        return torch.stack([-y, x, z], dim=-1)
    return torch.stack([-z, y, x], dim=-1)


def _to_x_quat(d, quat):
    return torch.cat([quat[..., :1], _to_x_vec(d, quat[..., 1:])], dim=-1)


def _nbr(a, d):
    """Value of the +d neighbour of a (..., X, Y, Z) tensor; wrapped
    entries are masked by bond_mask."""
    return torch.roll(a, -1, dims=d - 3)


def _nbrv(a, d):
    """`_nbr` for (..., X, Y, Z, k) tensors."""
    return torch.roll(a, -1, dims=d - 4)


def _from_nbr(a, d):
    """Bring a per-bond value back to the voxel at -d of the bond owner."""
    return torch.roll(a, 1, dims=d - 3)


def _from_nbrv(a, d):
    return torch.roll(a, 1, dims=d - 4)


def _check_envelope(state: SimState, body: VoxelBody, sim: SimParams,
                    env: EnvParams, dt_reduce):
    """Raise NotImplementedError for every feature outside the port's step."""
    refused = [
        ("volume effects", sim.volume_effects_enabled),
        ("plasticity", sim.plasticity_enabled),
        ("equilibrium mode", sim.equilibrium_mode),
        ("max-velocity clamp", sim.max_velocity_enabled),
        ("fluid environment", env.fluid_environment),
        ("limited floor", env.floor_limited),
        ("nonlinear materials", not body.all_linear),
        ("devo (initial voxel size)", body.using_initial_voxel_size),
        ("devo (final voxel size)", body.using_final_voxel_size),
        ("devo (growth time)", body.using_growth_time),
        ("devo (final phase offset)", body.using_final_phase_offset),
        ("devo (final temp amp damp)", body.using_final_temp_amp_damp),
        ("ballistic devo", state.devo is not None),
        ("dt reduction across shards", dt_reduce is not None),
    ]
    for name, on in refused:
        if on:
            raise NotImplementedError(f"sim_step: {name} is not ported yet")
    if bool((body.dof_fixed != 0).any()) or bool((body.external_force != 0).any()) \
            or bool((body.external_disp != 0).any()) \
            or bool((body.external_tdisp != 0).any()):
        raise NotImplementedError("sim_step: BC regions are not ported yet")


# ---------------------------------------------------------------------------
# Bond forces (reference: VXS_BondInternal.cpp:56-187 CalcLinForce
#              + 189-307 UpdateBondStrain + 310-346 AddDampForces)
# ---------------------------------------------------------------------------

def _bond_axis_forces(d, state: SimState, body: VoxelBody, sim: SimParams,
                      dt, L, prec: Precision):
    mask = body.bond_mask[..., d, :, :, :]
    maskf = mask[..., None]
    bd = lambda f: f[..., d, :, :, :]  # noqa: E731
    bdv = lambda f: f[..., d, :, :, :, :]  # noqa: E731

    rel = _to_x_vec(d, _nbrv(state.pos, d) - state.pos)
    q1 = _to_x_quat(d, state.quat)
    q2 = _to_x_quat(d, _nbrv(state.quat, d))

    ang1_rel = q.quat_rotate_inv(q1, rel)
    new_ang2 = q.quat_multiply(q.quat_conjugate(q1), q2)

    nom_dist = (state.scale + _nbr(state.scale, d)) * 0.5

    rx, ry, rz = ang1_rel.unbind(-1)
    small_turn = _safe_div(torch.abs(rz) + torch.abs(ry), rx)
    extend_perc = _safe_div(rx, nom_dist)

    sa_prev = state.small_angle[..., d, :, :, :]
    go_small = (
        (~sa_prev)
        & q.quat_is_small_angle(new_ang2, prec)
        & (small_turn < prec.sa_bond_bend_rad)
        & (extend_perc < SA_BOND_EXT_PERC)
    )
    go_large = sa_prev & (
        (~q.quat_is_smallish_angle(new_ang2, prec))
        | (small_turn > HYSTERESIS_FACTOR * prec.sa_bond_bend_rad)
        | (extend_perc > HYSTERESIS_FACTOR * SA_BOND_EXT_PERC)
    )
    small = torch.where(go_small, True, torch.where(go_large, False, sa_prev))
    changed = go_small | go_large

    # small-angle frame (reference: :87-100)
    a2_small = q.quat_to_rotation_vector(new_ang2, prec)
    pos2_small = torch.stack([rx - nom_dist, ry, rz], dim=-1)
    totrot_small = q.quat_conjugate(q1)

    # large-angle frame (reference: :101-118)
    p2ar = q.quat_from_angle_to_pos_x(ang1_rel, prec)
    totrot_large = q.quat_multiply(p2ar, q.quat_conjugate(q1))
    length = _safe_norm(*rel.unbind(-1))
    zero = torch.zeros_like(length)
    pos2_large = torch.stack([length - nom_dist, zero, zero], dim=-1)
    a1_large = q.quat_to_rotation_vector(p2ar, prec)
    a2_large = q.quat_to_rotation_vector(q.quat_multiply(totrot_large, q2), prec)

    sm = small[..., None]
    _pos2 = torch.where(sm, pos2_small, pos2_large)
    _a1 = torch.where(sm, torch.zeros_like(a1_large), a1_large)
    _a2 = torch.where(sm, a2_small, a2_large)
    totrot = torch.where(sm, totrot_small, totrot_large)

    # axial strain & linear two-material stress (reference: :189-307); for
    # linear materials the stress-equalization fixed point is exact after
    # one iteration and the entry tolerance reduces to a modulus test
    strain = _safe_div(_pos2[..., 0], L)
    E1, E2, E = bd(body.bond_e1), bd(body.bond_e2), bd(body.bond_e)
    s_sum = E1 + E2
    near_equal = torch.abs(E1 - E2) <= 0.0005 * torch.abs(s_sum)
    hom = bd(body.bond_homogeneous) | near_equal
    stress = torch.where(hom, 0.5 * s_sum * strain, E * strain)
    max_strain = torch.maximum(bd(state.max_strain), strain)
    strain_offset = bd(state.strain_offset)

    # beam forces/moments in the bond frame (reference: :122-154)
    a2c, b1, b2, b3 = bd(body.bond_a2), bd(body.bond_b1), bd(body.bond_b2), bd(body.bond_b3)
    cs_area = L * L  # CSArea1 = CSArea2 = NominalSize² without volume effects
    p2y, p2z = _pos2[..., 1], _pos2[..., 2]
    a1x, a1y, a1z = _a1.unbind(-1)
    a2x, a2y, a2z = _a2.unbind(-1)

    f1 = torch.stack([
        stress * cs_area,
        b1 * p2y - b2 * (a1z + a2z),
        b1 * p2z + b2 * (a1y + a2y),
    ], dim=-1)
    f2 = -f1
    m1 = torch.stack([
        a2c * (a1x - a2x),
        b2 * p2z + b3 * (2.0 * a1y + a2y),
        -b2 * p2y + b3 * (2.0 * a1z + a2z),
    ], dim=-1)
    m2 = torch.stack([
        a2c * (a2x - a1x),
        b2 * p2z + b3 * (a1y + 2.0 * a2y),
        -b2 * p2y + b3 * (a1z + 2.0 * a2z),
    ], dim=-1)

    # strain energy, bond frame, pre-damping (reference: VXS_Bond.cpp:115-122)
    a1 = bd(body.bond_a1)
    inv = lambda x: _safe_div(torch.ones_like(x), x)  # noqa: E731
    m1z, m2z = m1[..., 2], m2[..., 2]
    m1y, m2y = m1[..., 1], m2[..., 1]
    strain_energy = torch.where(
        mask,
        0.5 * inv(a1) * f1[..., 0] ** 2
        + 0.5 * inv(a2c) * m1[..., 0] ** 2
        + (1.0 / 3.0) * inv(b3) * (m1z * m1z - m1z * m2z + m2z * m2z)
        + (1.0 / 3.0) * inv(b3) * (m1y * m1y - m1y * m2y + m2y * m2y),
        0.0,
    )

    # critical damping from the frame-state memory (reference: :310-346)
    dt_inv = _safe_div(torch.ones_like(dt), dt)
    bondz = 0.5 * sim.bond_damping_z
    rv = (_pos2 - bdv(state.last_pos2)) * _vec(dt_inv)
    rav1 = (_a1 - bdv(state.last_angle1)) * _vec(dt_inv)
    rav2 = (_a2 - bdv(state.last_angle2)) * _vec(dt_inv)
    rvx, rvy, rvz = rv.unbind(-1)
    sum_avz = rav1[..., 2] + rav2[..., 2]
    sum_avy = rav1[..., 1] + rav2[..., 1]
    dmp = (~changed) & _vox(dt > 0)

    df1 = bondz * torch.stack([
        bd(body.d_a1m1) * rvx,
        bd(body.d_b1m1) * rvy - bd(body.d_b2fm1) * sum_avz,
        bd(body.d_b1m1) * rvz + bd(body.d_b2fm1) * sum_avy,
    ], dim=-1)
    df2 = bondz * torch.stack([
        -bd(body.d_a1m2) * rvx,
        -bd(body.d_b1m2) * rvy + bd(body.d_b2fm2) * sum_avz,
        -bd(body.d_b1m2) * rvz - bd(body.d_b2fm2) * sum_avy,
    ], dim=-1)
    davx = rav2[..., 0] - rav1[..., 0]
    dm1 = (0.5 * bondz) * torch.stack([
        -bd(body.d_a2i1) * davx,
        bd(body.d_b2fm1) * rvz + bd(body.d_b3i1) * (2.0 * rav1[..., 1] + rav2[..., 1]),
        -bd(body.d_b2fm1) * rvy + bd(body.d_b3i1) * (2.0 * rav1[..., 2] + rav2[..., 2]),
    ], dim=-1)
    dm2 = (0.5 * bondz) * torch.stack([
        bd(body.d_a2i2) * davx,
        bd(body.d_b2fm2) * rvz + bd(body.d_b3i2) * (rav1[..., 1] + 2.0 * rav2[..., 1]),
        -bd(body.d_b2fm2) * rvy + bd(body.d_b3i2) * (rav1[..., 2] + 2.0 * rav2[..., 2]),
    ], dim=-1)
    dmpf = dmp[..., None]
    f1 = f1 + torch.where(dmpf, df1, 0.0)
    f2 = f2 + torch.where(dmpf, df2, 0.0)
    m1 = m1 + torch.where(dmpf, dm1, 0.0)
    m2 = m2 + torch.where(dmpf, dm2, 0.0)

    # back to the world frame (reference: :159-170)
    f1 = _to_orig_vec(d, q.quat_rotate_inv(totrot, f1))
    f2 = _to_orig_vec(d, q.quat_rotate_inv(totrot, f2))
    m1 = _to_orig_vec(d, q.quat_rotate_inv(totrot, m1))
    m2 = _to_orig_vec(d, q.quat_rotate_inv(totrot, m2))

    f1 = torch.where(maskf, f1, 0.0)
    f2 = torch.where(maskf, f2, 0.0)
    m1 = torch.where(maskf, m1, 0.0)
    m2 = torch.where(maskf, m2, 0.0)

    # the damping memory is written inside AddDampForces, which the
    # reference skips on a small/large-angle transition step
    # (VXS_BondInternal.cpp:344-347): keep the old memory where `changed`
    keep = changed[..., None]
    new_last_pos2 = torch.where(keep, bdv(state.last_pos2), _pos2)
    new_last_a1 = torch.where(keep, bdv(state.last_angle1), _a1)
    new_last_a2 = torch.where(keep, bdv(state.last_angle2), _a2)

    return dict(
        f1=f1, f2=f2, m1=m1, m2=m2,
        strain_energy=strain_energy,
        strain=torch.where(mask, strain, 0.0),
        small_angle=torch.where(mask, small, sa_prev),
        last_pos2=torch.where(maskf, new_last_pos2, 0.0),
        last_angle1=torch.where(maskf, new_last_a1, 0.0),
        last_angle2=torch.where(maskf, new_last_a2, 0.0),
        max_strain=torch.where(mask, max_strain, 0.0),
        strain_offset=torch.where(mask, strain_offset, 0.0),
    )


# ---------------------------------------------------------------------------
# Floor contact + Coulomb friction (reference: VXS_Voxel.cpp:677-758)
# ---------------------------------------------------------------------------

def _floor_effect(state, body, sim: SimParams, env: EnvParams, vel,
                  total_force, dt):
    """Returns (floor_force, static_fric_mask, linmom, vel) with the
    reference's in-place momentum zeroing replicated."""
    pos = state.pos
    linmom = state.linmom

    pen = 0.5 * state.scale - pos[..., 2]
    pen = torch.where(pen > 0, pen, 0.0)
    contact = pen > 0

    normal_force = body.lin_stiffness * pen
    fz = normal_force - sim.col_damping_z * body.two_sq_mexs * vel[..., 2]
    fz = torch.where(contact, fz, 0.0)

    static_flag = torch.zeros_like(contact)
    lat = torch.tensor([True, True, False], device=pos.device)

    # sticky floor (reference: :736-739)
    if env.sticky_floor:
        stick = contact
        linmom = torch.where(stick[..., None] & lat, 0.0, linmom)
        vel = torch.where(stick[..., None] & lat, 0.0, vel)
        static_flag = static_flag | stick

    vx, vy = vel[..., 0], vel[..., 1]
    stopped = (vx == 0.0) & (vy == 0.0)
    surface_vel = _safe_norm(vx, vy)
    surface_force = _safe_norm(total_force[..., 0], total_force[..., 1])
    dyn_fric = body.u_dynamic * normal_force

    # static: stopped & too little lateral force to break away (:741-743)
    static_flag = static_flag | (
        contact & stopped & (surface_force < body.u_static * normal_force))

    # dynamic: friction opposes velocity unless it would reverse it (:744-753)
    moving = contact & ~stopped
    keeps_moving = dyn_fric * _vox(dt) < body.mass * surface_vel
    inv_sv = _safe_div(torch.ones_like(surface_vel), surface_vel)
    fric_x = -vx * inv_sv * dyn_fric
    fric_y = -vy * inv_sv * dyn_fric
    fx = torch.where(moving & keeps_moving, fric_x, 0.0)
    fy = torch.where(moving & keeps_moving, fric_y, 0.0)
    stopping = moving & ~keeps_moving
    static_flag = static_flag | stopping
    linmom = torch.where(stopping[..., None] & lat, 0.0, linmom)

    floor_force = torch.stack([fx, fy, fz], dim=-1)
    return floor_force, static_flag, linmom, vel


# ---------------------------------------------------------------------------
# Actuation scale update (reference: VXS_Voxel.cpp:224-341)
# ---------------------------------------------------------------------------

def _scale_update(state, body, sim: SimParams, env: EnvParams, t):
    """New per-voxel scale: thermal actuation with the mid-life freeze and
    the reference's rate clamps (devo terms are outside the envelope)."""
    nom = torch.full_like(state.scale, body.nominal_size)
    max_scale = (1.0 + _vox(env.growth_amplitude)) * nom
    min_scale = _vox(sim.min_temp_fact) * nom
    last = state.last_scale
    tv = _vox(t)

    if env.temp_enabled:
        amp_q = _vox(_f32(env.temp_amplitude, nom))
        period_q = _vox(_f32(env.temp_period, nom))
        t_over_period = _safe_div(tv, period_q)
        ctrl = (
            body.temp_amp_damp
            * (amp_q * torch.sin(2.0 * REF_PI_FLOAT * (t_over_period + body.phase_offset)))
            * body.cte
        )
        ctrl = torch.where(
            (tv >= _vox(sim.init_cm_time)) & (_vox(env.temp_period) != 0), ctrl, 0.0)
        # FreezeInitialized: actuation is zeroed for the first InitCmTime of
        # the mid-life freeze window (reference: VXS_Voxel.cpp:234-256, :302)
        freeze = sim.mid_life_freeze_time
        middle = 0.5 * (sim.stop_condition_value - sim.init_cm_time)
        fs = middle - 0.5 * freeze
        freeze_uninit = (
            (freeze > 0)
            & (tv > _vox(fs))
            & (tv < _vox(middle + 0.5 * freeze))
            & (tv < _vox(fs + sim.init_cm_time))
        )
        ctrl = torch.where(freeze_uninit, 0.0, ctrl)
    else:
        ctrl = torch.zeros_like(nom)

    curr = ctrl * nom + nom
    curr = torch.where((curr < last) & (curr < min_scale), last, curr)
    curr = torch.where((curr > last) & (curr > max_scale), last, curr)
    return torch.where(body.occ, curr, nom)


# ---------------------------------------------------------------------------
# The full step
# ---------------------------------------------------------------------------

def sim_step(
    state: SimState,
    body: VoxelBody,
    sim: SimParams,
    env: EnvParams,
    dt,
    prec: Precision = DEFAULT_PRECISION,
    control_offset=None,
    dt_reduce=None,
) -> SimState:
    """Advance one dt (reference: VX_Sim.cpp:1763 Integrate).

    `state` may carry a leading batch shape; `body` is either one design
    (broadcast) or a batch of designs of the same shape. `dt` and the env
    scalars may be floats or tensors of the batch shape. `control_offset`
    is the MPC actuation channel: a (..., X, Y, Z) scale modulation, in
    fractions of the nominal size, added after the actuation clamps.
    """
    _check_envelope(state, body, sim, env, dt_reduce)
    t = state.time
    occ = body.occ
    occf = occ[..., None]
    dt = torch.as_tensor(dt, dtype=state.pos.dtype, device=state.pos.device)
    L = torch.tensor(body.nominal_size, dtype=state.pos.dtype,
                     device=state.pos.device)

    # ---- bond pass (3 lattice directions) ----
    bonds = [_bond_axis_forces(d, state, body, sim, dt, L, prec)
             for d in range(3)]

    diverged_now = state.diverged
    for d in range(3):
        diverged_now = diverged_now | (
            torch.abs(bonds[d]["strain"]) > DIVERGENCE_STRAIN).flatten(-3).any(-1)

    # ---- per-voxel force accumulation (reference: VXS_Voxel.cpp:482-651) ----
    vel = state.linmom * body.mass_inv[..., None]
    total_force = -sim.slow_damping_z * vel * body.two_sq_mexs[..., None]
    for d in range(3):
        total_force = total_force + bonds[d]["f1"] + _from_nbrv(bonds[d]["f2"], d)

    # self-collision contact (reference: VXS_Voxel.cpp:516-528)
    if sim.self_collisions_enabled and body.collision is not None:
        total_force = total_force + _collision(state, body)

    if env.gravity_enabled:
        gz = torch.zeros_like(total_force)
        gz[..., 2] = body.mass * _vox(env.grav_acc)
        total_force = total_force + gz

    linmom = state.linmom
    if env.floor_enabled:
        floor_force, static_flag, linmom, vel = _floor_effect(
            state, body, sim, env, vel, total_force, dt)
        total_force = total_force + floor_force
        lateral_zero = static_flag[..., None] & torch.tensor(
            [True, True, False], device=total_force.device)
        total_force = torch.where(lateral_zero, 0.0, total_force)

    total_force = torch.where(occf, total_force, 0.0)

    # ---- linear integration (reference: VXS_Voxel.cpp:181-197) ----
    linmom = linmom + total_force * _vec(dt)
    disp = linmom * (_vec(dt) * body.mass_inv[..., None])
    pos = state.pos + disp

    # ---- moments (reference: VXS_Voxel.cpp:653-675 CalcTotalMoment) ----
    total_moment = torch.zeros_like(state.angmom)
    for d in range(3):
        total_moment = total_moment - bonds[d]["m1"] - _from_nbrv(bonds[d]["m2"], d)
    total_moment = torch.where(occf, total_moment, 0.0)

    angmom = state.angmom + total_moment * _vec(dt)
    ang_fact = 1.0 - 10.0 * sim.slow_damping_z * body.inertia_inv \
        * body.two_sq_iexsss * _vox(dt)
    angmom = angmom * ang_fact[..., None]

    # quaternion integration (reference: :210-215)
    ang_vel = angmom * body.inertia_inv[..., None]
    spin = 0.5 * q.quat_multiply(
        torch.cat([torch.zeros_like(ang_vel[..., :1]), ang_vel], dim=-1),
        state.quat)
    quat = q.quat_normalize_fast(state.quat + spin * _vec(dt))

    # keep empty cells inert
    pos = torch.where(occf, pos, body.nom_pos)
    linmom = torch.where(occf, linmom, 0.0)
    angmom = torch.where(occf, angmom, 0.0)

    # ---- actuation (reference: :224-341) ----
    new_scale = _scale_update(state, body, sim, env, t)
    if control_offset is not None:
        # MPC direct actuation channel: additive scale modulation
        ctrl_off = torch.as_tensor(control_offset, dtype=new_scale.dtype,
                                   device=new_scale.device)
        new_scale = new_scale + torch.where(occ, ctrl_off * L, 0.0)

    # ---- kinetic energy and strain-energy bookkeeping ----
    vel_new = linmom * body.mass_inv[..., None]
    angvel_new = angmom * body.inertia_inv[..., None]
    ke = 0.5 * (
        body.mass * (vel_new * vel_new).sum(-1)
        + body.inertia * (angvel_new * angvel_new).sum(-1)
    ).flatten(-3).sum(-1)
    ke_history = torch.cat(
        [ke[..., None], state.ke_history[..., :-1]], dim=-1)
    total_strain_e = sum(b["strain_energy"].flatten(-3).sum(-1) for b in bonds)
    max_vox_vel = torch.sqrt(torch.where(
        occ, (vel_new * vel_new).sum(-1), 0.0).flatten(-3).amax(-1))

    new_state = SimState(
        pos=pos,
        quat=quat,
        linmom=linmom,
        angmom=angmom,
        scale=new_scale,
        last_scale=new_scale,
        small_angle=torch.stack([b["small_angle"] for b in bonds], dim=-4),
        last_pos2=torch.stack([b["last_pos2"] for b in bonds], dim=-5),
        last_angle1=torch.stack([b["last_angle1"] for b in bonds], dim=-5),
        last_angle2=torch.stack([b["last_angle2"] for b in bonds], dim=-5),
        max_strain=torch.stack([b["max_strain"] for b in bonds], dim=-4),
        strain_offset=torch.stack([b["strain_offset"] for b in bonds], dim=-4),
        time=t + dt,
        diverged=diverged_now,
        ke_history=ke_history,
        total_strain_e=total_strain_e,
        max_vox_vel=max_vox_vel,
    )

    # freeze the state once diverged (reference aborts: VX_Sim.cpp:1774-1777)
    return freeze_where(state.diverged, state, new_state)


def freeze_where(frozen, old: SimState, new: SimState) -> SimState:
    """Per robot, `old` where `frozen` (a tensor of the batch shape), else
    `new`; fields that are None stay None."""
    nb = frozen.dim()
    out = {}
    for f in ("pos", "quat", "linmom", "angmom", "scale", "last_scale",
              "small_angle", "last_pos2", "last_angle1", "last_angle2",
              "max_strain", "strain_offset", "time", "diverged", "ke_history",
              "total_strain_e", "max_vox_vel"):
        a, b = getattr(old, f), getattr(new, f)
        if a is None or b is None:
            out[f] = b
            continue
        fz = frozen.reshape(frozen.shape + (1,) * (b.dim() - nb))
        out[f] = torch.where(fz, a, b)
    return new.replace(**out)


def _collision(state: SimState, body: VoxelBody):
    """Contact forces from the body's collision tables: a CollisionSystem
    (one design), or the dense (..., V, V) pair table of the fused path."""
    if isinstance(body.collision, CollisionSystem):
        return collision_forces(state.pos, state.scale, body.collision)
    from evosoro_tpu_torch.ops.fused_rollout import pair_contact_forces_plain

    shp = state.pos.shape
    pos = state.pos.flatten(-4, -2).transpose(-1, -2)  # (..., 3, V)
    scale = state.scale.flatten(-3)
    f = pair_contact_forces_plain(pos, scale, body.collision)
    return f.transpose(-1, -2).reshape(shp)

