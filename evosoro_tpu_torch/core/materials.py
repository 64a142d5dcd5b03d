"""Palette -> per-voxel / per-bond constant precomputation, in torch.

Replicates the derived quantities of the reference engine:
- per-voxel mass/inertia/damping factors (reference: VX_Voxel.cpp:95-128)
- per-bond composite moduli and beam constants (reference: VX_Bond.cpp:65-173)
- stability timestep (reference: VX_Sim.cpp:1693-1727 CalcMaxDt)
- the import-time transforms of a genome's development outputs
  (reference: VX_Sim.cpp:878-965, `devo_params_from_vxa`)
"""

from __future__ import annotations

import dataclasses

from typing import Sequence

import numpy as np
import torch

from evosoro_tpu_torch.core.constants import REF_PI_DOUBLE
from evosoro_tpu_torch.core.types import (
    MDL_BILINEAR,
    MDL_DATA,
    Material,
    MaterialPalette,
    VoxelBody,
    validate_ss_data,
)


def palette_from_list(materials: Sequence[Material], dtype=torch.float32,
                      device=None) -> MaterialPalette:
    """Pack Material entries into id-indexed tensors. Index 0 = empty space."""
    materials = [
        validate_ss_data(m) if m.mat_model == MDL_DATA else m
        for m in materials
    ]
    n = max(m.id for m in materials) + 1
    f = {k: np.zeros(n) for k in (
        "elastic_mod", "density", "poisson", "cte", "u_static", "u_dynamic",
        "plastic_mod", "yield_stress", "fail_stress", "fail_strain",
        "mat_temp_phase")}
    mat_model = np.zeros(n, dtype=np.int32)
    for m in materials:
        f["elastic_mod"][m.id] = m.elastic_mod
        f["density"][m.id] = m.density
        f["poisson"][m.id] = m.poissons_ratio
        f["cte"][m.id] = m.cte
        f["u_static"][m.id] = m.u_static
        f["u_dynamic"][m.id] = m.u_dynamic
        f["plastic_mod"][m.id] = m.plastic_mod
        f["yield_stress"][m.id] = m.yield_stress
        f["fail_stress"][m.id] = m.fail_stress
        f["fail_strain"][m.id] = m.fail_strain
        f["mat_temp_phase"][m.id] = m.mat_temp_phase
        mat_model[m.id] = m.mat_model

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    # MDL_DATA tables padded to the palette-wide max point count: strain
    # pads with a +1e30 sentinel, stress with the last value
    ss = {}
    if any(m.mat_model == MDL_DATA for m in materials):
        P = max(len(m.ss_strain) for m in materials if m.mat_model == MDL_DATA)
        ss_strain = np.full((n, P), 1e30)
        ss_stress = np.zeros((n, P))
        ss_last_slope = np.zeros(n)
        ss_last_stress = np.zeros(n)
        ss_strain[:, 0] = 0.0
        for m in materials:
            if m.mat_model != MDL_DATA:
                continue
            k = len(m.ss_strain)
            ss_strain[m.id, :k] = m.ss_strain
            ss_stress[m.id, :k] = m.ss_stress
            ss_stress[m.id, k:] = m.ss_stress[-1]
            ss_last_stress[m.id] = m.ss_stress[-1]
            slope = (m.ss_stress[-1] - m.ss_stress[-2]) / (
                m.ss_strain[-1] - m.ss_strain[-2])
            ss_last_slope[m.id] = max(slope, 0.0) if (
                m.ss_stress[-1] >= m.ss_stress[-2]) else 0.0
        ss = dict(ss_strain=t(ss_strain), ss_stress=t(ss_stress),
                  ss_last_slope=t(ss_last_slope),
                  ss_last_stress=t(ss_last_stress))
    return MaterialPalette(
        **{k: t(v) for k, v in f.items()},
        mat_model=t(mat_model, torch.int32),
        num_materials=n - 1,
        **ss,
    )


def _safe_div(a, b):
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, 1.0), 0.0)


def _nbr(a, d):
    """Value at the +d neighbour of a (..., X, Y, Z) tensor; the wrapped
    slab is masked by bond_mask."""
    return torch.roll(a, -1, dims=d - 3)


def build_body(
    structure,
    palette: MaterialPalette,
    lattice_dim=0.01,
    phase_offset=None,
    final_phase_offset=None,
    temp_amp_damp=None,
    final_temp_amp_damp=None,
    initial_voxel_size=None,
    final_voxel_size=None,
    growth_time=None,
    start_growth_time=None,
    stiffness=None,
    cte_scale=None,
    stiffness_plasticity_rate=None,
    kp=None,
    ki=None,
    antiwindup=None,
    dof_fixed=None,
    external_force=None,
    external_disp=None,
    external_tdisp=None,
    dtype=torch.float32,
    device=None,
) -> VoxelBody:
    """Build the static VoxelBody from a (X,Y,Z) integer array of material
    ids on `device`. Optional per-voxel arrays mirror the VXC
    <PhaseOffset>/<Stiffness>/... tags (reference: VX_Object.h:183-258)."""
    device = torch.device(device) if device is not None else palette.elastic_mod.device
    structure = torch.as_tensor(np.asarray(structure), dtype=torch.int64,
                                device=device)
    X, Y, Z = structure.shape
    occ = structure > 0
    # the lattice pitch is a float32 scalar in the JAX package; every
    # constant below is computed from that rounded value
    L = torch.tensor(lattice_dim, dtype=dtype, device=device)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               device=device).to(dt)

    def g(field):  # gather a palette property per voxel
        return field.to(device=device, dtype=dtype)[structure]

    e_mod = g(palette.elastic_mod)
    if stiffness is not None:
        s = t(stiffness)
        e_mod = torch.where((s > 0) & occ, s, e_mod)
    density = g(palette.density)
    poisson = g(palette.poisson)
    cte = g(palette.cte)
    if cte_scale is not None:
        cte = cte * t(cte_scale)
    u_static = g(palette.u_static)
    u_dynamic = g(palette.u_dynamic)

    # voxel centres at (i+0.5)*L (reference: VX_Object.cpp:538-543 GetXYZ)
    ix, iy, iz = torch.meshgrid(
        torch.arange(X, device=device), torch.arange(Y, device=device),
        torch.arange(Z, device=device), indexing="ij")
    nom_pos = (torch.stack([ix, iy, iz], dim=-1).to(dtype) + 0.5) * L

    # mass/inertia (reference: VX_Voxel.cpp:109-125)
    vol = L * L * L
    mass = torch.where(occ, vol * density, 0.0)
    inertia = mass * (L * L) / 6.0
    first_moment = mass * L / 2.0
    mass_inv = _safe_div(torch.ones_like(mass), mass)
    inertia_inv = _safe_div(torch.ones_like(inertia), inertia)
    two_sq_mexs = 2.0 * torch.sqrt(mass * e_mod * L)
    two_sq_iexsss = 2.0 * torch.sqrt(inertia * e_mod * L * L * L)
    lin_stiffness = 2.0 * e_mod * L  # floor normal stiffness (VX_Voxel.h:64)

    # ---- per-bond constants (3,X,Y,Z) ----
    def edge_ok(d):  # True except on the last slab along axis d
        return (ix, iy, iz)[d] < structure.shape[d] - 1

    bm, bhom, be, be1, be2 = [], [], [], [], []
    for d in range(3):
        mask = occ & _nbr(occ, d) & edge_ok(d)
        e1, e2 = e_mod, _nbr(e_mod, d)
        bm.append(mask)
        bhom.append(mask & (structure == _nbr(structure, d)))
        be.append(torch.where(mask, 2.0 * _safe_div(e1 * e2, e1 + e2), 0.0))
        be1.append(torch.where(mask, e1, 0.0))
        be2.append(torch.where(mask, e2, 0.0))
    bond_mask = torch.stack(bm)
    bond_homogeneous = torch.stack(bhom)
    bond_e = torch.stack(be)
    bond_e1 = torch.stack(be1)
    bond_e2 = torch.stack(be2)

    u1 = poisson.expand(3, X, Y, Z)
    u2 = torch.stack([_nbr(poisson, d) for d in range(3)])
    bond_u, bond_eh = poisson_bond_fields(bond_e1, bond_e2, u1, u2)

    # beam geometry for a cubic section (reference: VX_Bond.cpp:123-141)
    # L**k as jax's integer_pow computes it (binary powering)
    L2 = L * L
    L3 = L * L2
    L4 = L2 * L2
    A = L2
    I = L4 / 12.0  # noqa: E741
    J = L4 / 6.0
    G_over_E = 1.0 / (2.0 * (1.0 + bond_u))
    bond_a1 = bond_e * A / L
    bond_a2 = bond_e * G_over_E * J / L
    bond_b1 = 12.0 * bond_e * I / L3
    bond_b2 = 6.0 * bond_e * I / L2
    bond_b3 = 2.0 * bond_e * I / L

    # critical damping coefficients 2*sqrt(k*m) (reference: VX_Bond.cpp:149-170)
    def side2(a):
        return torch.stack([_nbr(a, d) for d in range(3)])

    def dcoef(k, m):
        return 2.0 * torch.sqrt(torch.clamp(k * m, min=0.0))

    m1, m2 = mass.expand(3, X, Y, Z), side2(mass)
    i1, i2 = inertia.expand(3, X, Y, Z), side2(inertia)
    fm1, fm2 = first_moment.expand(3, X, Y, Z), side2(first_moment)

    zeros = torch.zeros((X, Y, Z), dtype=dtype, device=device)
    ones = torch.ones((X, Y, Z), dtype=dtype, device=device)

    def opt(a, like=zeros):
        return t(a) if a is not None else like

    def opt_f32(a, like=zeros):
        """Devo/actuation fields round through float32: the reference stores
        them as `float` members (VXS_Voxel.h:91-110)."""
        return t(a, torch.float32).to(dtype) if a is not None else like

    mm = palette.mat_model.cpu().numpy()
    all_linear = bool(np.all((mm != MDL_BILINEAR) & (mm != MDL_DATA)))

    ss_fields = {}
    if palette.ss_strain is not None:
        ss_fields = dict(
            ss_strain_vox=palette.ss_strain.to(device)[structure],
            ss_stress_vox=palette.ss_stress.to(device)[structure],
            ss_fail_strain_vox=g(palette.fail_strain),
            ss_last_stress_vox=g(palette.ss_last_stress),
            ss_last_slope_vox=g(palette.ss_last_slope),
        )

    return VoxelBody(
        occ=occ,
        mat=structure.to(torch.int32),
        nom_pos=nom_pos,
        nominal_size=float(L),
        mass=mass,
        mass_inv=mass_inv,
        inertia=inertia,
        inertia_inv=inertia_inv,
        first_moment=first_moment,
        e_mod=e_mod,
        poisson=poisson,
        cte=cte,
        u_static=u_static,
        u_dynamic=u_dynamic,
        lin_stiffness=lin_stiffness,
        two_sq_mexs=two_sq_mexs,
        two_sq_iexsss=two_sq_iexsss,
        phase_offset=opt_f32(phase_offset),
        final_phase_offset=opt_f32(final_phase_offset),
        temp_amp_damp=opt_f32(temp_amp_damp, ones),
        final_temp_amp_damp=opt_f32(final_temp_amp_damp, ones),
        initial_voxel_size=opt_f32(initial_voxel_size),
        final_voxel_size=opt_f32(final_voxel_size),
        growth_time=opt_f32(growth_time),
        start_growth_time=opt_f32(start_growth_time),
        dof_fixed=(t(dof_fixed, torch.int32) if dof_fixed is not None
                   else torch.zeros((X, Y, Z), dtype=torch.int32, device=device)),
        external_force=opt(external_force, zeros[..., None].expand(X, Y, Z, 3)),
        external_disp=opt(external_disp, zeros[..., None].expand(X, Y, Z, 3)),
        external_tdisp=opt(external_tdisp, zeros[..., None].expand(X, Y, Z, 3)),
        bond_mask=bond_mask,
        bond_homogeneous=bond_homogeneous,
        bond_e=bond_e,
        bond_e1=bond_e1,
        bond_e2=bond_e2,
        bond_a1=bond_a1,
        bond_a2=bond_a2,
        bond_b1=bond_b1,
        bond_b2=bond_b2,
        bond_b3=bond_b3,
        d_a1m1=dcoef(bond_a1, m1),
        d_a1m2=dcoef(bond_a1, m2),
        d_a2i1=dcoef(bond_a2, i1),
        d_a2i2=dcoef(bond_a2, i2),
        d_b1m1=dcoef(bond_b1, m1),
        d_b1m2=dcoef(bond_b1, m2),
        d_b2fm1=dcoef(bond_b2, fm1),
        d_b2fm2=dcoef(bond_b2, fm2),
        d_b3i1=dcoef(bond_b3, i1),
        d_b3i2=dcoef(bond_b3, i2),
        stiffness_plasticity_rate=(
            opt_f32(stiffness_plasticity_rate)
            if stiffness_plasticity_rate is not None else None),
        kp=opt_f32(kp) if kp is not None else None,
        ki=opt_f32(ki) if ki is not None else None,
        antiwindup=opt_f32(antiwindup) if antiwindup is not None else None,
        plastic_mod=g(palette.plastic_mod),
        yield_stress=g(palette.yield_stress),
        mat_temp_phase=g(palette.mat_temp_phase),
        mat_model_vox=palette.mat_model.to(device)[structure],
        bond_u=bond_u,
        bond_eh=bond_eh,
        all_linear=all_linear,
        using_phase_offset=phase_offset is not None,
        using_final_phase_offset=final_phase_offset is not None,
        using_temp_amp_damp=temp_amp_damp is not None,
        using_final_temp_amp_damp=final_temp_amp_damp is not None,
        using_initial_voxel_size=initial_voxel_size is not None,
        using_final_voxel_size=final_voxel_size is not None,
        using_growth_time=growth_time is not None,
        using_start_growth_time=start_growth_time is not None,
        **ss_fields,
    )


def stack_bodies(bodies, device=None) -> VoxelBody:
    """One VoxelBody for a batch of designs of one grid: every tensor field
    stacked along a new leading axis on `device`. The Python fields (the
    lattice pitch, the material and development switches) must agree; the
    collision and mesh-drag tables are attached by the caller
    (`core.collision.stack_collision_systems`,
    `envs.drag.build_mesh_drag_batch`)."""
    out = {}
    for f in dataclasses.fields(VoxelBody):
        vals = [getattr(b, f.name) for b in bodies]
        if f.name in ("collision", "mesh_drag"):
            out[f.name] = None
        elif torch.is_tensor(vals[0]):
            out[f.name] = torch.stack(vals).to(device)
        elif vals[0] is None or all(v == vals[0] for v in vals):
            if any((v is None) != (vals[0] is None) for v in vals):
                raise ValueError(f"stack_bodies: {f.name} is set on some bodies only")
            out[f.name] = vals[0]
        else:
            raise ValueError(f"stack_bodies: the bodies' {f.name} differ")
    return VoxelBody(**out)


def devo_params_from_vxa(raw: dict, sim, env, nominal_size, structure) -> dict:
    """Apply the reference's import-time devo transforms (reference:
    VX_Sim.cpp:878-965 ResetSimulation), on the host in numpy.

    The VXA's per-voxel devo arrays hold normalized genome outputs
    (sigmoids in [-1,1]/[0,1]); the engine maps them to physical sizes and
    absolute times at import:

    - InitialVoxelSize/FinalVoxelSize: size = max(1 + growth_amplitude·raw,
      min_temp_fact) · nominal_size; absent initial -> nominal; absent final
      -> initial (no growth).
    - StartGrowthTime: raw·(onset_bound − init_cm_time) + init_cm_time,
      capped at onset_bound − min_growth_time; absent -> init_cm_time when
      any size/growth output is evolved else "never" (stop − freeze).
    - GrowthTime: raw·(termination_bound − start − freeze), floored at
      min_growth_time; absent -> full window when a final size is evolved.

    onset/termination bounds are the parent's lifetime when the env marks
    them relative (reference: VX_Sim.cpp:888-889), else the stop condition.

    `raw` keys (lowercase): initialvoxelsize, finalvoxelsize, growthtime,
    startgrowthtime, with values (X,Y,Z) arrays or None. Returns kwargs for
    `build_body` (actual sizes [m] / times [s]), omitting absent outputs.
    """
    raw_init = raw.get("initialvoxelsize")
    raw_final = raw.get("finalvoxelsize")
    raw_growth = raw.get("growthtime")
    raw_start = raw.get("startgrowthtime")
    if all(a is None for a in (raw_init, raw_final, raw_growth, raw_start)):
        return {}

    stop = float(sim.stop_condition_value)
    init_cm = float(sim.init_cm_time)
    freeze = float(sim.mid_life_freeze_time)
    parent = float(getattr(sim, "parent_lifetime", 0.0)) or stop
    # the bounds are float32 voxel members in the reference
    # (VXS_Voxel.h:102-103 onsetBound/terminationBound): quantize to match
    onset_bound = float(np.float32(parent if env.onset_relative else stop))
    term_bound = float(np.float32(parent if env.termination_relative else stop))
    gamp = float(env.growth_amplitude)
    min_tf = float(sim.min_temp_fact)
    min_gt = float(env.min_growth_time)
    L = float(nominal_size)
    shape = np.asarray(structure).shape

    if raw_init is not None:
        init_size = np.maximum(1.0 + gamp * np.asarray(raw_init), min_tf) * L
    else:
        init_size = np.full(shape, L)
    if raw_final is not None:
        final_size = np.maximum(1.0 + gamp * np.asarray(raw_final), min_tf) * L
    else:
        final_size = init_size

    if raw_start is not None:
        start = np.asarray(raw_start) * (onset_bound - init_cm) + init_cm
        start = np.minimum(start, onset_bound - min_gt)
    elif raw_final is not None or raw_growth is not None:
        start = np.full(shape, init_cm)
    else:
        start = np.full(shape, stop - freeze)
    # startGrowthTime is stored float32 before growthTime reads it back
    # (reference: VXS_Voxel.h:97, VX_Sim.cpp:958-974)
    start = np.float64(np.float32(start))

    if raw_growth is not None:
        growth = np.asarray(raw_growth) * (term_bound - start - freeze)
        growth = np.maximum(growth, min_gt)
    elif raw_final is not None:
        growth = term_bound - start - freeze
    else:
        growth = np.full(shape, min_gt)

    out = {"start_growth_time": start, "growth_time": growth}
    if raw_init is not None:
        out["initial_voxel_size"] = init_size
    if raw_final is not None or raw_init is not None:
        out["final_voxel_size"] = final_size
    return out


def poisson_bond_fields(e1, e2, u1, u2):
    """(bond_u, bond_eh) of bonds whose sides have moduli e1, e2 (zero off
    the bond mask) and Poisson ratios u1, u2: the composite Poisson ratio
    2 u1 u2 / (u1 + u2) (reference: VX_Bond.cpp:91-92) and the volume-effects
    modulus, the harmonic mean of each side's E / ((1 - 2u)(1 + u)) (the
    reference's live UpdateConstants path, VX_Bond.cpp:90-97)."""
    bond_u = torch.where(u1 + u2 != 0, 2.0 * _safe_div(u1 * u2, u1 + u2), 0.0)

    def side_eh(e, u):
        denom = (1.0 - 2.0 * u) * (1.0 + u)
        return torch.where(denom != 0, _safe_div(e, denom), e)

    e1h, e2h = side_eh(e1, u1), side_eh(e2, u2)
    bond_eh = torch.where(e1h + e2h != 0, 2.0 * _safe_div(e1h * e2h, e1h + e2h), 0.0)
    return bond_u, bond_eh


def calc_max_dt(body: VoxelBody, volume_effects: bool = False) -> torch.Tensor:
    """Stability timestep 1/(2π·max√(k/m)) over all bonds
    (reference: VX_Sim.cpp:1693-1727), a scalar (or batch-shaped) tensor.
    With `volume_effects` k is the bond's rest effective stiffness Eh·L."""
    if volume_effects:
        k = body.bond_eh * body.nominal_size
    else:
        k = body.bond_a1
    m1 = body.mass.unsqueeze(-4).expand(k.shape)
    m2 = torch.stack([_nbr(body.mass, d) for d in range(3)], dim=-4)
    f2_1 = torch.where(body.bond_mask, _safe_div(k, m1), 0.0)
    f2_2 = torch.where(body.bond_mask, _safe_div(k, m2), 0.0)
    max_freq2 = torch.maximum(f2_1.flatten(-4).amax(-1), f2_2.flatten(-4).amax(-1))
    max_freq = torch.sqrt(max_freq2)
    # truncated π replicates the reference's dt bit for bit (VX_Sim.cpp:1725)
    return torch.where(
        max_freq > 0, 1.0 / (2.0 * REF_PI_DOUBLE * max_freq), 0.0)
