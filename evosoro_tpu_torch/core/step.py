"""One physics timestep over the dense voxel lattice, eager torch.

The port of `evosoro_tpu.core.step.sim_step` (reference call stack:
VX_Sim.cpp:1054 TimeStep -> 1763 Integrate -> VXS_BondInternal.cpp:56
CalcLinForce -> VXS_Voxel.cpp:169 EulerStep). Everything is dense
`(..., X, Y, Z)` tensors with an optional leading batch shape; bonds live
on the 3 positive lattice directions and each voxel gathers its 6
neighbour contributions by shifted reads. Every branch of the reference is
a `torch.where` selection, as in the JAX step.

This is the port's own CPU reference and the plain version of the fused
rollout kernel. It covers: linear, bilinear and MDL_DATA materials (the
per-side stress with the reference's stress-equalization loop) with
plasticity's max-strain memory, beam bonds with small/large-angle
hysteresis and bond damping, slow damping, self-collision, gravity, floor
contact with Coulomb friction and the sticky floor, boundary-condition
regions (external forces, fixed and prescribed degrees of freedom), Euler
and angular integration with the max-velocity clamp, equilibrium mode,
thermal actuation with the mid-life freeze, the fluid environment of the
land_water fork (facet drag on the deformed surface mesh, or the
voxel-face approximation, and its simpler actuation) and development
(prenatal and growth ramps, final phase offset and amplitude damping,
size-capped actuation, and the ballistic rebase of a state's DevoState
from its speed windows) and volume effects (the Poisson-coupled bond
stress with its thermal term, the per-step dt and the voxel pass's
transverse coupling) and the circular limited floor. Dt reduction across
shards raises NotImplementedError.
"""

from __future__ import annotations

import torch

from evosoro_tpu_torch.core import quaternion as q
from evosoro_tpu_torch.core.collision import CollisionSystem, collision_forces
from evosoro_tpu_torch.core.constants import (
    DEFAULT_PRECISION,
    DIVERGENCE_STRAIN,
    HYSTERESIS_FACTOR,
    REF_PI_DOUBLE,
    REF_PI_FLOAT,
    SA_BOND_EXT_PERC,
    Precision,
)
from evosoro_tpu_torch.core.types import (
    DOF_TX,
    DOF_TY,
    DOF_TZ,
    DOF_X,
    DOF_Y,
    DOF_Z,
    MDL_BILINEAR,
    MDL_DATA,
    EnvParams,
    SimParams,
    SimState,
    VoxelBody,
)


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


def has_bc(body: VoxelBody) -> bool:
    """True when the body carries boundary conditions: a fixed degree of
    freedom, an external force or a prescribed displacement or rotation."""
    return bool((body.dof_fixed != 0).any() or (body.external_force != 0).any()
                or (body.external_disp != 0).any() or (body.external_tdisp != 0).any())


def _vox_mat_stress(strain, e_mod, mat_model, plastic_mod, yield_stress, ss=None):
    """Material-model stress at a strain (reference: VX_Object.cpp:1472-1535
    GetModelStress). MDL_LINEAR / MDL_LINEAR_FAIL are the linear curve
    (failure only sets bookkeeping flags); MDL_BILINEAR kinks at the yield
    point; MDL_DATA interpolates the material's stress-strain point table
    (`ss`: the per-voxel tables the body carries, None when no palette entry
    is MDL_DATA)."""
    linear = e_mod * strain
    yield_strain = _safe_div(yield_stress, e_mod)
    bilinear = torch.where(strain > yield_strain,
                           yield_stress + plastic_mod * (strain - yield_strain), linear)
    out = torch.where(mat_model == MDL_BILINEAR, bilinear, linear)
    if ss is not None:
        xs, ys = ss["xs"], ss["ys"]  # (..., P)
        P = xs.shape[-1]
        # first segment i with xs[i+1] > strain; padded entries are +1e30 so
        # they never count, and strain < 0 lands in segment 0: the linear
        # extrapolation of the first segment (reference: VX_Object.cpp:1505-1517)
        seg = (xs[..., 1:P - 1] <= strain[..., None]).sum(-1)
        hit = seg[..., None] == torch.arange(P - 1, device=strain.device)

        def pick(a):  # the segment's entry, exactly
            return torch.where(hit, a, 0.0).sum(-1)

        x1, x2 = pick(xs[..., :-1]), pick(xs[..., 1:])
        y1, y2 = pick(ys[..., :-1]), pick(ys[..., 1:])
        interp = y1 + _safe_div(strain - x1, x2 - x1) * (y2 - y1)
        past = ss["last_stress"] + ss["last_slope"] * (strain - ss["fail"])
        data = torch.where(strain < ss["fail"], interp, past)
        out = torch.where(mat_model == MDL_DATA, data, out)
    return out


def _nonlinear_stress(d, strain, body: VoxelBody):
    """(stress, sv1, sv2) of a bond between voxels of any material model:
    the per-side stress with the reference's 3-iteration stress-equalization
    loop (reference: VXS_BondInternal.cpp:237-253)."""
    side1 = (body.e_mod, body.mat_model_vox, body.plastic_mod, body.yield_stress)
    side2 = tuple(_nbr(a, d) for a in side1)
    ss1 = ss2 = None
    if body.ss_strain_vox is not None:
        ss1 = dict(xs=body.ss_strain_vox, ys=body.ss_stress_vox,
                   fail=body.ss_fail_strain_vox, last_stress=body.ss_last_stress_vox,
                   last_slope=body.ss_last_slope_vox)
        ss2 = {k: _nbrv(v, d) if k in ("xs", "ys") else _nbr(v, d) for k, v in ss1.items()}
    sv1 = sv2 = strain
    s1 = _vox_mat_stress(sv1, *side1, ss=ss1)
    s2 = _vox_mat_stress(sv2, *side2, ss=ss2)
    for _ in range(3):
        ssum = s1 + s2
        converged = torch.abs(s1 - s2) <= 0.0005 * torch.abs(ssum)
        sv1 = torch.where(converged, sv1, 2.0 * _safe_div(s2, ssum) * sv1)
        sv2 = torch.where(converged, sv2, 2.0 * _safe_div(s1, ssum) * sv2)
        s1 = _vox_mat_stress(sv1, *side1, ss=ss1)
        s2 = _vox_mat_stress(sv2, *side2, ss=ss2)
    hom = body.bond_homogeneous[..., d, :, :, :]
    stress_hom = _vox_mat_stress(strain, *side1, ss=ss1)
    stress = torch.where(hom, stress_hom, 0.5 * (s1 + s2))
    return stress, torch.where(hom, strain, sv1), torch.where(hom, strain, sv2)


def _thermal_stress(d, state: SimState, body: VoxelBody, env: EnvParams):
    """The thermal stress volume effects take off a bond of direction d:
    the mean of its sides' E CTE dT / (1 - 2u), each side's dT from its
    material's temperature sinusoid at the step's start, or the amplitude
    when the temperature does not vary (reference:
    VXS_BondInternal.cpp:284-298, VX_Environment.cpp:442-461)."""
    if env.vary_temp_enabled:
        t = _vox(state.time)
        period = _vox(torch.as_tensor(env.temp_period, dtype=t.dtype, device=t.device))
        # the float-truncated pi of VX_Environment.cpp:451
        w = 2.0 * REF_PI_FLOAT * t * _safe_div(torch.ones_like(period), period)
        amp = _vox(env.temp_amplitude)
        dT1 = torch.where(period != 0, amp * torch.sin(w + body.mat_temp_phase), 0.0)
        dT2 = torch.where(period != 0, amp * torch.sin(w + _nbr(body.mat_temp_phase, d)), 0.0)
    else:
        dT1 = dT2 = _vox(env.temp_amplitude)
    s1t = _safe_div(body.e_mod * body.cte * dT1, 1.0 - 2.0 * body.poisson)
    s2t = _safe_div(_nbr(body.e_mod, d) * _nbr(body.cte, d) * dT2,
                    1.0 - 2.0 * _nbr(body.poisson, d))
    return 0.5 * (s1t + s2t)


def _volume_dt(state: SimState, body: VoxelBody, sim: SimParams, bonds, L, dt,
               dt_reduce=None):
    """The dt volume effects recompute after the bond pass, per robot:
    DtFrac / (2 pi max sqrt(k_eff / m)) over its bonds, k_eff = Eh (CS1 +
    CS2) / (2 (e L + L)) with this step's strain and the carried sections
    (VXS_Bond.h:34, VX_Sim.cpp:1792-1794); `dt` where no bond is stiff.
    `dt_reduce` maps the largest frequency before dt is taken from it: a
    spatially-sharded step (`parallel.spatial`) gives the largest over the
    slabs, so every slab steps by the same dt."""
    cs_sum = state.cs_area[..., 0, :, :, :, :] + state.cs_area[..., 1, :, :, :, :]
    strains = torch.stack([b["strain"] for b in bonds], dim=-4)
    eff_k = body.bond_eh * cs_sum / (2.0 * (strains * L + L))
    m1 = body.mass.unsqueeze(-4)
    m2 = torch.stack([_nbr(body.mass, d) for d in range(3)], dim=-4)
    f2 = torch.maximum(torch.where(body.bond_mask, _safe_div(eff_k, m1), 0.0),
                       torch.where(body.bond_mask, _safe_div(eff_k, m2), 0.0))
    max_freq = torch.sqrt(f2.flatten(-4).amax(-1))
    if dt_reduce is not None:
        max_freq = dt_reduce(max_freq)
    frac = torch.full_like(max_freq, sim.dt_frac)
    return torch.where(max_freq > 0, frac / (2.0 * REF_PI_DOUBLE * max_freq), dt)


def _volume_effects_coupling(bonds, body: VoxelBody):
    """The voxel pass's Poisson coupling (reference: VXS_Voxel.cpp:543-632).

    From this step's per-direction bond strains, each voxel's strain along
    each axis (its two bonds' mean; a constrained axis counts as bonded on
    both sides), the exclusive (Tx, Ty, Tz) case table's transverse
    contraction pow(1+e, -mu) - 1 on the free axes, and from those each
    bond side's transverse strain sum and cross-section for the next step.
    Returns (ts_sum, cs_area), each (..., 2, 3, X, Y, Z)."""
    mu = body.poisson
    L2 = body.nominal_size * body.nominal_size
    masks = [body.bond_mask[..., d, :, :, :] for d in range(3)]
    T, axis_strain = [], []
    for a, bit in enumerate((DOF_X, DOF_Y, DOF_Z)):
        pd, nd = masks[a], _from_nbr(masks[a], a)
        sp, sn = bonds[a]["sv1"], _from_nbr(bonds[a]["sv2"], a)
        constrained = ((body.dof_fixed & bit) != 0) | (body.external_force[..., a] != 0)
        T.append((pd & nd) | ((pd | nd) & constrained))
        s = torch.where(pd & nd, 0.5 * (sp + sn),
                        torch.where(pd, sp, torch.where(nd, sn, 0.0)))
        axis_strain.append(torch.where(T[a], s, 0.0))

    def pw(s):  # transverse contraction; 1 + e > 0 keeps pow finite
        return torch.pow(torch.clamp(1.0 + s, min=1e-6), -mu) - 1.0

    tx, ty, tz = T
    c0x, c0y, c0z = axis_strain
    # the exclusive (Tx, Ty, Tz) case table (reference: :586-594)
    cx = torch.where(~tx & ty & tz, pw(c0y + c0z), torch.where(
        ~tx & ~ty & tz, pw(c0z), torch.where(~tx & ty & ~tz, pw(c0y), c0x)))
    cy = torch.where(tx & ~ty & tz, pw(c0x + c0z), torch.where(
        ~tx & ~ty & tz, pw(c0z), torch.where(tx & ~ty & ~tz, pw(c0x), c0y)))
    cz = torch.where(tx & ty & ~tz, pw(c0x + c0y), torch.where(
        ~tx & ty & ~tz, pw(c0y), torch.where(tx & ~ty & ~tz, pw(c0x), c0z)))
    # each bond axis's transverse sum and area from the two other axes
    # (reference: :601-620; AXIS_Z takes y + x)
    ts_ax = [cy + cz, cx + cz, cy + cx]
    cs_ax = [(1.0 + cy) * (1.0 + cz) * L2, (1.0 + cx) * (1.0 + cz) * L2,
             (1.0 + cy) * (1.0 + cx) * L2]
    ts1 = torch.stack([torch.where(masks[d], ts_ax[d], 0.0) for d in range(3)], dim=-4)
    ts2 = torch.stack([torch.where(masks[d], _nbr(ts_ax[d], d), 0.0) for d in range(3)],
                      dim=-4)
    cs1 = torch.stack([torch.where(masks[d], cs_ax[d], L2) for d in range(3)], dim=-4)
    cs2 = torch.stack([torch.where(masks[d], _nbr(cs_ax[d], d), L2) for d in range(3)],
                      dim=-4)
    return torch.stack([ts1, ts2], dim=-5), torch.stack([cs1, cs2], dim=-5)


# ---------------------------------------------------------------------------
# Bond forces (reference: VXS_BondInternal.cpp:56-187 CalcLinForce
#              + 189-307 UpdateBondStrain + 310-346 AddDampForces)
# ---------------------------------------------------------------------------

def _bond_axis_forces(d, state: SimState, body: VoxelBody, sim: SimParams,
                      env: EnvParams, dt, L, prec: Precision):
    mask = body.bond_mask[..., d, :, :, :]
    maskf = mask[..., None]
    bd = lambda f: f[..., d, :, :, :]  # noqa: E731
    bdv = lambda f: f[..., d, :, :, :, :]  # noqa: E731

    rel = _to_x_vec(d, _nbrv(state.pos, d) - state.pos)
    q1 = _to_x_quat(d, state.quat)
    q2 = _to_x_quat(d, _nbrv(state.quat, d))

    ang1_rel = q.quat_rotate_inv(q1, rel)
    new_ang2 = q.quat_multiply(q.quat_conjugate(q1), q2)

    vol = sim.volume_effects_enabled
    if vol:  # the rest length is the nominal lattice (VXS_Bond.cpp)
        nom_dist = L.expand_as(state.scale)
    else:
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

    # axial strain & two-material stress (reference: :189-307); for linear
    # materials the stress-equalization fixed point is exact after one
    # iteration and the entry tolerance reduces to a modulus test
    strain = _safe_div(_pos2[..., 0], L)
    E = bd(body.bond_e)
    if vol:
        # Poisson-coupled stress s = Eh(1-u)e + Eh u (TS1+TS2)/2 from the
        # transverse strain sums the voxel pass wrote last step (reference:
        # VXS_BondInternal.cpp:200-222); the per-side strains of a
        # heterogeneous bond stay at their initial 0 (VXS_Bond.cpp:66-67)
        u, eh = bd(body.bond_u), bd(body.bond_eh)
        ts_avg = 0.5 * (state.ts_sum[..., 0, d, :, :, :] + state.ts_sum[..., 1, d, :, :, :])
        stress = eh * (1.0 - u) * strain + eh * u * ts_avg
        sv1 = sv2 = torch.where(bd(body.bond_homogeneous), strain, 0.0)
    elif body.all_linear:
        E1, E2 = bd(body.bond_e1), bd(body.bond_e2)
        s_sum = E1 + E2
        near_equal = torch.abs(E1 - E2) <= 0.0005 * torch.abs(s_sum)
        hom = bd(body.bond_homogeneous) | near_equal
        stress = torch.where(hom, 0.5 * s_sum * strain, E * strain)
        # per-side strains: the linear fixed point of the stress equalization
        sv1 = torch.where(hom, strain, 2.0 * _safe_div(E2, s_sum) * strain)
        sv2 = torch.where(hom, strain, 2.0 * _safe_div(E1, s_sum) * strain)
    else:
        stress, sv1, sv2 = _nonlinear_stress(d, strain, body)

    if sim.plasticity_enabled:
        # plastic high-water memory (reference: VXS_BondInternal.cpp:193-207):
        # new-territory strains follow the material curve; inside it the
        # stress unloads linearly from the strain offset
        new_territory = strain >= bd(state.max_strain)
        stress = torch.where(new_territory, stress, E * (strain - bd(state.strain_offset)))
        max_strain = torch.maximum(bd(state.max_strain), strain)
        strain_offset = torch.where(new_territory, max_strain - _safe_div(stress, E),
                                    bd(state.strain_offset))
    else:
        max_strain = torch.maximum(bd(state.max_strain), strain)
        strain_offset = bd(state.strain_offset)

    if vol and env.temp_enabled:
        stress = stress - _thermal_stress(d, state, body, env)

    # beam forces/moments in the bond frame (reference: :122-154)
    a2c, b1, b2, b3 = bd(body.bond_a2), bd(body.bond_b1), bd(body.bond_b2), bd(body.bond_b3)
    if vol:  # F_axial = s (CSArea1 + CSArea2)/2 (reference: :127)
        cs_area = 0.5 * (state.cs_area[..., 0, d, :, :, :] + state.cs_area[..., 1, d, :, :, :])
    else:
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
        sv1=torch.where(mask, sv1, 0.0),
        sv2=torch.where(mask, sv2, 0.0),
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
    if env.floor_limited:
        # the circular limited floor around the workspace's centre
        # (reference: VXS_Voxel.cpp:677-700 insideLimitedFloor); X and Y from
        # the grid's own axes, so that a batch of bodies works
        X, Y = body.occ.shape[-3:-1]
        dx = pos[..., 0] - body.nominal_size * X * 0.5
        dy = pos[..., 1] - body.nominal_size * Y * 0.5
        r = torch.sqrt(dx ** 2 + dy ** 2)
        inside = (r <= _vox(env.floor_radius)) & (pos[..., 2] >= 0)
        pen = torch.where(inside, pen, 0.0)
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
    """(new per-voxel scale, new DevoState): thermal actuation with the
    mid-life freeze, the development ramps and the reference's rate clamps,
    with the ballistic rebase of `state.devo` when it is set; or the fluid
    environment's simpler actuation, which leaves `state.devo` as it is."""
    nom = torch.full_like(state.scale, body.nominal_size)
    tv = _vox(t)

    if env.fluid_environment:
        # the land_water fork's simpler actuation: no devo machinery, no
        # amp-damp, no rate-limited clamps; a hard floor at the #define'd
        # MIN_TEMP_FACTOR=0.1 (reference: land_water VXS_Voxel.cpp:210-236,
        # VX_Sim.h:31). Gated on temp_enabled alone.
        if env.temp_enabled:
            amp_q = _vox(_f32(env.temp_amplitude, nom))
            period_q = _vox(_f32(env.temp_period, nom))
            ctrl = amp_q * torch.sin(
                2.0 * REF_PI_FLOAT * (_safe_div(tv, period_q) + body.phase_offset)
            ) * body.cte
            temp_fact = 1.0 + torch.where(
                (tv >= _vox(sim.init_cm_time)) & (_vox(env.temp_period) != 0),
                ctrl, 0.0)
        else:
            temp_fact = torch.ones_like(nom)
        temp_fact = torch.clamp(temp_fact, min=0.1)
        return torch.where(body.occ, temp_fact * nom, nom), state.devo

    max_scale = (1.0 + _vox(env.growth_amplitude)) * nom
    min_scale = _vox(sim.min_temp_fact) * nom
    last = state.last_scale
    devo_size = body.using_initial_voxel_size or body.using_final_voxel_size
    # the development fields come from the dynamic DevoState under ballistic
    # development, else from the body
    devo = state.devo
    src = body if devo is None else devo
    initial_size, final_size = src.initial_voxel_size, src.final_voxel_size
    start, growth = src.start_growth_time, src.growth_time

    # prenatal linear development ramp (reference: VXS_Voxel.cpp:237-238)
    prenatal = dev_temp_fact = None
    if body.using_initial_voxel_size:
        init_cm = _vox(torch.as_tensor(sim.init_cm_time, dtype=nom.dtype,
                                       device=nom.device))
        c = torch.where(tv >= 0.5 * init_cm, 1.0, _safe_div(2.0 * tv, init_cm))
        prenatal = c * (_safe_div(initial_size, nom) - 1.0)

    # postnatal development (reference: :263-289)
    dev_phase = dev_ampdamp = None
    if body.using_growth_time or body.using_final_voxel_size:
        # mid-life development freeze (reference: :242-265): FrozenTimeAdj =
        # clamp(t - FreezeStart, 0, FreezeTime) pauses the effective
        # development clock inside the freeze window
        freeze = sim.mid_life_freeze_time
        middle = 0.5 * (sim.stop_condition_value - sim.init_cm_time)
        frozen_adj = torch.clamp(tv - _vox(middle - 0.5 * freeze), 0.0, freeze)
        growing = (tv >= start) & (growth > 0)
        eff_t = torch.minimum(tv, start + growth + freeze) - frozen_adj
        k = torch.where(growing, _safe_div(eff_t - start, growth), 0.0)
        if body.using_final_voxel_size:
            dev_temp_fact = k * (_safe_div(final_size, initial_size) - 1.0)
        if body.using_final_phase_offset:
            dev_phase = k * (body.final_phase_offset - body.phase_offset)
        if body.using_final_temp_amp_damp:
            dev_ampdamp = k * (body.final_temp_amp_damp - body.temp_amp_damp)

    if env.temp_enabled:
        phase = body.phase_offset if dev_phase is None else body.phase_offset + dev_phase
        amp_damp = body.temp_amp_damp if dev_ampdamp is None \
            else body.temp_amp_damp + dev_ampdamp
        amp_q = _vox(_f32(env.temp_amplitude, nom))
        period_q = _vox(_f32(env.temp_period, nom))
        t_over_period = _safe_div(tv, period_q)
        ctrl = (
            amp_damp
            * (amp_q * torch.sin(2.0 * REF_PI_FLOAT * (t_over_period + phase)))
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

    # the size development has reached: (1 + prenatal)(1 + dev_temp_fact) L
    grown = nom
    if devo_size:
        grow_fact = torch.ones_like(nom)
        if prenatal is not None:
            grow_fact = grow_fact * (1.0 + prenatal)
        if dev_temp_fact is not None:
            grow_fact = grow_fact * (1.0 + dev_temp_fact)
        grown = grow_fact * nom
        # size-capped actuation for devo bodies (reference: :308-320)
        gamp = _vox(torch.as_tensor(env.growth_amplitude, dtype=nom.dtype,
                                    device=nom.device))
        orig_sig = _safe_div(_safe_div(grown, nom) - 1.0, gamp)
        pos_sig = (orig_sig + 1.0) * 0.5
        capped = torch.clamp(pos_sig, max=0.5)
        ctrl = ctrl * capped * 2.0

    curr = ctrl * nom + grown
    curr = torch.where((curr < last) & (curr < min_scale), last, curr)
    curr = torch.where((curr > last) & (curr > max_scale), last, curr)
    new_scale = torch.where(body.occ, curr, nom)
    if devo is None:
        return new_scale, None
    return new_scale, _ballistic_rebase(devo, sim, env, tv, grown, nom)


def _ballistic_rebase(devo, sim: SimParams, env: EnvParams, tv, cur_size, nom):
    """Ballistic velocity-adjusted development (reference:
    VXS_Voxel.cpp:342-381): once two speed windows exist, every step rebases
    development at the current size `cur_size`; if the windowed speed fell
    by more than MaxSlowdownPermitted, the final size is pulled toward the
    current size by BallisticSlowdownFact."""
    time_in_window = int(env.num_trace_steps_in_window) * env.time_between_traces
    ready = (_vox(devo.win_count) >= 2) & (
        tv >= _vox(sim.init_cm_time + 2.0 * time_in_window))
    apply = ready & (tv >= devo.start_growth_time + env.min_growth_time)

    this_speed, last_speed = _vox(devo.win_last), _vox(devo.win_prev)
    ratio = _safe_div(this_speed, torch.where(last_speed != 0, last_speed, 1.0))
    decreasing = ((last_speed > 0) & (this_speed < last_speed)
                  & (ratio < 1.0 - env.max_slowdown_permitted))
    adj = 1.0 - decreasing.to(nom.dtype) * env.ballistic_slowdown_fact
    suggested = cur_size + (devo.final_voxel_size - cur_size) * adj
    orig = devo.original_final_voxel_size
    # monotonicity and original-bound clamps (reference: :367-377)
    up = orig > cur_size
    sugg_up = torch.minimum(suggested, orig)
    fin_up = torch.where(sugg_up >= cur_size, sugg_up, cur_size)
    sugg_dn = torch.maximum(suggested, orig)
    fin_dn = torch.where(sugg_dn <= cur_size, sugg_dn, cur_size)
    reb_final = torch.where(up, fin_up, fin_dn)
    reb_growth = torch.clamp(devo.growth_time - (tv - devo.start_growth_time), min=0.0)

    def q(x):  # the reference stores these fields as float32
        return x.to(torch.float32).to(nom.dtype)

    return devo.replace(
        initial_voxel_size=torch.where(apply, q(cur_size), devo.initial_voxel_size),
        final_voxel_size=torch.where(apply, q(reb_final), devo.final_voxel_size),
        growth_time=torch.where(apply, q(reb_growth), devo.growth_time),
        start_growth_time=torch.where(apply, q(tv.expand_as(nom)), devo.start_growth_time),
    )


# ---------------------------------------------------------------------------
# Fluid drag, voxel-face model
# ---------------------------------------------------------------------------

def _fluid_drag(state, body, env: EnvParams, vel):
    """Per-exposed-face quadratic drag, the voxel-level analog of the
    land_water facet drag (reference: land_water VX_Sim.cpp:1516-1600).

    Each of a voxel's 6 faces that has no bonded neighbour is an exposed
    surface patch of area scale²; drag = -C·A·|v_n|·v_n per face along the
    face normal, accumulated onto the voxel. It matches the facet model up
    to the deformed-mesh vs axis-aligned-face approximation."""
    area = state.scale * state.scale
    c_area = _vox(env.aggregate_drag_coefficient) * area
    comps = []
    for d in range(3):
        has_pos = body.bond_mask[..., d, :, :, :]
        has_neg = _from_nbr(has_pos, d)
        drag_d = torch.zeros_like(area)
        for sign, exposed in ((1.0, body.occ & ~has_pos), (-1.0, body.occ & ~has_neg)):
            vn = sign * vel[..., d]  # velocity along the outward normal
            # only forward-facing faces see drag
            mag = torch.where(exposed & (vn > 0), c_area * vn * vn, 0.0)
            drag_d = drag_d + (-sign) * mag
        comps.append(drag_d)
    return torch.stack(comps, dim=-1)


# ---------------------------------------------------------------------------
# The full step
# ---------------------------------------------------------------------------

def _max_vel_clamp(disp, limit):
    """The per-step displacement clamp (reference: VXS_Voxel.cpp:188-192):
    `disp` (..., 3) scaled back to length `limit` where it is longer."""
    dmag = _safe_norm(*disp.unbind(-1))[..., None]
    max_disp = torch.full_like(dmag, limit)
    return disp * torch.where(dmag > max_disp,
                              max_disp / torch.where(dmag > 0, dmag, 1.0), 1.0)


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
    `dt_reduce`, under volume effects, maps the step's largest bond
    frequency before its dt is taken from it (`parallel.spatial` gives the
    largest over the slabs), where the JAX package applies it
    (evosoro_tpu/core/step.py:844-847).
    """
    # equilibrium mode overrides the damping configuration for the whole run
    # (reference: EnableEquilibriumMode, VX_Sim.cpp:1351-1372: BondDampingZ
    # 0.1, SlowDampingZ 0, the max-velocity clamp off)
    if sim.equilibrium_mode:
        sim = sim.replace(bond_damping_z=0.1, slow_damping_z=0.0,
                          max_velocity_enabled=False)
    t = state.time
    occ = body.occ
    occf = occ[..., None]
    dt = torch.as_tensor(dt, dtype=state.pos.dtype, device=state.pos.device)
    L = torch.tensor(body.nominal_size, dtype=state.pos.dtype,
                     device=state.pos.device)
    vol = sim.volume_effects_enabled
    if vol and (state.ts_sum is None or state.cs_area is None):
        raise ValueError("volume effects enabled but the state has no coupling carry; "
                         "create it with init_state(body, volume_effects=True)")
    if vol and state.cur_dt is not None:
        # the bond damping pass reads the PREVIOUS step's dt (the reference
        # updates its dt after UpdateBond, VX_Sim.cpp:1792-1795); 0 means
        # the caller's dt
        dt = torch.where(state.cur_dt > 0, state.cur_dt, dt)

    # ---- bond pass (3 lattice directions) ----
    bonds = [_bond_axis_forces(d, state, body, sim, env, dt, L, prec)
             for d in range(3)]

    new_ts_sum = new_cs_area = None
    if vol:
        # everything from the Euler step on uses the recomputed dt, and the
        # voxel pass's coupling gives the next step's carry
        dt = _volume_dt(state, body, sim, bonds, L, dt, dt_reduce)
        new_ts_sum, new_cs_area = _volume_effects_coupling(bonds, body)

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

    # a fluid environment is neutrally buoyant and has no floor (land_water
    # VX_Environment.cpp:190-191)
    if env.gravity_enabled and not env.fluid_environment:
        gz = torch.zeros_like(total_force)
        gz[..., 2] = body.mass * _vox(env.grav_acc)
        total_force = total_force + gz
    # boundary conditions apply whether or not a region is set, as in the
    # JAX step: zeros and cleared bits leave the state as it is
    total_force = total_force + body.external_force

    if env.fluid_environment:
        if body.mesh_drag is not None:
            # facet drag on the deformed surface mesh. The mesh corners come
            # from the per-direction bond strains written THIS step by the
            # bond pass (land_water VXS_Voxel.cpp:474-475): the reference's
            # Integrate runs bonds, then voxels.
            from evosoro_tpu_torch.envs.drag import mesh_drag_forces

            masks = [body.bond_mask[..., d, :, :, :] for d in range(3)]
            strain_pos = torch.stack([
                torch.where(masks[d], bonds[d]["sv1"], 0.0) for d in range(3)
            ], dim=-4)
            strain_neg = torch.stack([
                torch.where(_from_nbr(masks[d], d),
                            _from_nbr(bonds[d]["sv2"], d), 0.0)
                for d in range(3)
            ], dim=-4)
            total_force = total_force + mesh_drag_forces(
                state.pos, state.quat, state.scale, state.linmom,
                body.mass_inv, body.mesh_drag, env.aggregate_drag_coefficient,
                strain_pos=strain_pos, strain_neg=strain_neg,
                nominal_size=body.nominal_size)
        else:
            total_force = total_force + _fluid_drag(state, body, env, vel)

    linmom = state.linmom
    if env.floor_enabled and not env.fluid_environment:
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
    if sim.max_velocity_enabled:
        disp = _max_vel_clamp(disp, sim.max_vox_vel_limit * body.nominal_size)
    pos = state.pos + disp
    # fixed translational DOFs sit at their prescribed place (:195-197)
    fixed = torch.stack([(body.dof_fixed & bit) != 0 for bit in (DOF_X, DOF_Y, DOF_Z)],
                        dim=-1)
    pos = torch.where(fixed, body.nom_pos + body.external_disp, pos)
    linmom = torch.where(fixed, 0.0, linmom)

    # ---- moments (reference: VXS_Voxel.cpp:653-675 CalcTotalMoment) ----
    total_moment = torch.zeros_like(state.angmom)
    for d in range(3):
        total_moment = total_moment - bonds[d]["m1"] - _from_nbrv(bonds[d]["m2"], d)
    rot = torch.stack([(body.dof_fixed & bit) != 0 for bit in (DOF_TX, DOF_TY, DOF_TZ)],
                      dim=-1)
    total_moment = torch.where(rot, 0.0, total_moment)
    total_moment = torch.where(occf, total_moment, 0.0)

    angmom = state.angmom + total_moment * _vec(dt)
    if vol:  # fixed angular damping (reference: VXS_Voxel.cpp:204)
        angmom = angmom / torch.full_like(angmom, 1.01)
    else:
        ang_fact = 1.0 - 10.0 * sim.slow_damping_z * body.inertia_inv \
            * body.two_sq_iexsss * _vox(dt)
        angmom = angmom * ang_fact[..., None]

    # quaternion integration (reference: :210-215)
    ang_vel = angmom * body.inertia_inv[..., None]
    spin = 0.5 * q.quat_multiply(
        torch.cat([torch.zeros_like(ang_vel[..., :1]), ang_vel], dim=-1),
        state.quat)
    quat = q.quat_normalize_fast(state.quat + spin * _vec(dt))

    # all-rotation-fixed voxels hold the prescribed orientation (reference:
    # :218-221); fully fixed voxels their pose (:174-179)
    rot_all = DOF_TX | DOF_TY | DOF_TZ
    rot_fixed = ((body.dof_fixed & rot_all) == rot_all)[..., None]
    quat = torch.where(rot_fixed, q.quat_from_rotation_vector(body.external_tdisp), quat)
    angmom = torch.where(rot_fixed, 0.0, angmom)
    all_fixed = ((body.dof_fixed & 63) == 63)[..., None]
    pos = torch.where(all_fixed, body.nom_pos + body.external_disp, pos)
    linmom = torch.where(all_fixed, 0.0, linmom)

    # keep empty cells inert
    pos = torch.where(occf, pos, body.nom_pos)
    linmom = torch.where(occf, linmom, 0.0)
    angmom = torch.where(occf, angmom, 0.0)

    # ---- actuation and development (reference: :224-381) ----
    new_scale, new_devo = _scale_update(state, body, sim, env, t)
    if control_offset is not None:
        # MPC direct actuation channel: additive scale modulation
        ctrl_off = torch.as_tensor(control_offset, dtype=new_scale.dtype,
                                   device=new_scale.device)
        new_scale = new_scale + torch.where(occ, ctrl_off * L, 0.0)

    # ---- kinetic energy bookkeeping and equilibrium mode ----
    # the reference's KineticEDecreasing test reads the ring BEFORE this
    # step's KE is pushed, and ZeroAllMotion also clears the per-voxel
    # energy, so the value pushed is the energy after the zeroing
    # (reference: VX_Sim.cpp:1148-1155)
    if sim.equilibrium_mode:
        h = state.ke_history
        decreasing = _vec(h[..., 0] + h[..., 1] + h[..., 2] < h[..., 3] + h[..., 4] + h[..., 5])
        linmom = torch.where(decreasing, 0.0, linmom)
        angmom = torch.where(decreasing, 0.0, angmom)
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
        ts_sum=new_ts_sum,
        cs_area=new_cs_area,
        cur_dt=dt.expand_as(t).clone() if vol and state.cur_dt is not None else None,
        devo=new_devo,
        ke_history=ke_history,
        total_strain_e=total_strain_e,
        max_vox_vel=max_vox_vel,
    )

    # freeze the state once diverged (reference aborts: VX_Sim.cpp:1774-1777)
    return freeze_where(state.diverged, state, new_state)


def _select(frozen, old, new, fields):
    """{field: old where `frozen` else new} over `fields`; a field that is
    None on either side takes `new`'s value."""
    nb = frozen.dim()
    out = {}
    for f in fields:
        a, b = getattr(old, f), getattr(new, f)
        if a is None or b is None:
            out[f] = b
            continue
        fz = frozen.reshape(frozen.shape + (1,) * (b.dim() - nb))
        out[f] = torch.where(fz, a, b)
    return out


_DEVO_FIELDS = ("initial_voxel_size", "final_voxel_size", "original_final_voxel_size",
                "growth_time", "start_growth_time", "win_prev", "win_last", "win_count")


def freeze_where(frozen, old: SimState, new: SimState) -> SimState:
    """Per robot, `old` where `frozen` (a tensor of the batch shape), else
    `new`; fields that are None stay None."""
    out = _select(frozen, old, new, (
        "pos", "quat", "linmom", "angmom", "scale", "last_scale",
        "small_angle", "last_pos2", "last_angle1", "last_angle2",
        "max_strain", "strain_offset", "time", "diverged", "ke_history",
        "total_strain_e", "max_vox_vel", "ts_sum", "cs_area", "cur_dt"))
    if old.devo is not None and new.devo is not None:
        out["devo"] = new.devo.replace(**_select(frozen, old.devo, new.devo, _DEVO_FIELDS))
    return new.replace(**out)


def _collision(state: SimState, body: VoxelBody):
    """Contact forces from the body's collision tables: a CollisionSystem
    of one design or a stack of them, one a robot
    (`core.collision.stack_collision_systems`, the eager evaluator's), or
    the fused path's dense (..., V, V) pair table or its surface-compacted
    table (`ops.fused_rollout.CompactTable`)."""
    if isinstance(body.collision, CollisionSystem):
        return collision_forces(state.pos, state.scale, body.collision)
    from evosoro_tpu_torch.ops.fused_rollout import (
        CompactTable,
        pair_contact_forces_compact_plain,
        pair_contact_forces_plain,
    )

    shp = state.pos.shape
    pos = state.pos.flatten(-4, -2).transpose(-1, -2)  # (..., 3, V)
    scale = state.scale.flatten(-3)
    if isinstance(body.collision, CompactTable):
        f = pair_contact_forces_compact_plain(pos, scale, body.collision.table)
    else:
        f = pair_contact_forces_plain(pos, scale, body.collision)
    return f.transpose(-1, -2).reshape(shp)

