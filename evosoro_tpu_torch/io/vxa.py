"""VXA file format: reader, writer, fitness-XML parser.

The port of `evosoro_tpu.io.vxa`, host-only numpy. The VXA XML file is the
reference's full engine config schema: the Simulator block (reference:
VX_Sim.cpp:263-356 ReadXML), the Environment block
(VX_Environment.cpp:123-298), and the VXC lattice/palette/structure with
per-voxel arrays (VX_Object.cpp:444-473, 1748-2321). `load_vxa` reads a
file into a `VXADocument`, whose `build_body` makes the design's body
(boundary-condition regions rasterized onto the lattice); `write_vxa`
mirrors tools/read_write_voxelyze.py:40-407, so the reference `voxelyze`
binary accepts the files unmodified; `read_fitness_xml` parses the
reference's result file.

Layer ordering: one <Layer> CDATA per z-slice, scanned y-major then x
(reference: read_write_voxelyze.py:353-357), i.e. flat index = x + X*y.
"""

from __future__ import annotations

import dataclasses
import re
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from evosoro_tpu_torch.core.types import (
    DOF_ALL,
    EnvParams,
    Material,
    NeuralNetParams,
    SimParams,
)

# Stop conditions (reference: VX_Sim.h StopCondition enum)
SC_NONE = 0
SC_MAX_TIME_STEPS = 1
SC_MAX_SIM_TIME = 2
SC_TEMP_CYCLES = 3
SC_CONST_MAXENERGY = 4
SC_MIN_KE = 5
SC_MIN_MAXMOVE = 6

# Region primitive types (reference: VX_FRegion.h PrimTypes)
PRIM_BOX = 0
PRIM_CYLINDER = 1
PRIM_SPHERE = 2
PRIM_MESH = 3

# Per-voxel array tags the VXC structure can carry
# (reference: VX_Object.h:183-258 / VX_Object.cpp:1879-2321)
VOXEL_ARRAY_TAGS = (
    "PhaseOffset",
    "FinalPhaseOffset",
    "TempAmpDamp",
    "FinalTempAmpDamp",
    "InitialVoxelSize",
    "FinalVoxelSize",
    "GrowthTime",
    "StartGrowthTime",
    "Stiffness",
    "StiffnessPlasticityRate",
    "KP",
    "KI",
    "ANTIWINDUP",
)


@dataclasses.dataclass
class BCRegion:
    """One boundary-condition region (reference: VX_FRegion.{h,cpp}).

    Coordinates are normalized [0,1] fractions of the workspace.
    """

    prim_type: int = PRIM_BOX
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    dx: float = 0.0
    dy: float = 0.0
    dz: float = 0.0
    radius: float = 0.0
    dof_fixed: int = 0
    force: tuple = (0.0, 0.0, 0.0)
    torque: tuple = (0.0, 0.0, 0.0)
    displace: tuple = (0.0, 0.0, 0.0)
    ang_displace: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class VXADocument:
    """Everything parsed out of one .vxa file."""

    sim: SimParams
    env: EnvParams
    lattice_dim: float
    materials: list
    structure: np.ndarray  # (X,Y,Z) int material ids
    voxel_arrays: dict  # tag -> (X,Y,Z) float array
    bcs: list
    stop_condition_type: int = SC_MAX_SIM_TIME
    stop_condition_value: float = 5.0
    fitness_file_name: str = ""
    write_fitness_file: bool = False
    save_traces: bool = False
    time_between_traces: float = 0.0
    norm_dist_by_vol: bool = False
    normalization_exponent: float = 1.0
    falling_prohibited: bool = False
    needle_in_haystack: bool = False
    # per-material thermal phases, id-indexed (reference writer emits per-
    # material <TempPhase> when actuation_variance > 0)
    qhull_tmp_file: str = ""
    curvatures_tmp_file: str = ""

    def build_body(self, dtype=None, device=None):
        """The VoxelBody of this design on `device`: the card when none is
        named (without one this raises), `device="cpu"` for the plain
        versions."""
        import torch

        from evosoro_tpu_torch.core.materials import (
            build_body,
            devo_params_from_vxa,
            palette_from_list,
        )
        from evosoro_tpu_torch.device import resolve_device

        device = resolve_device(device)
        dtype = dtype or torch.float32
        palette = palette_from_list(self.materials, dtype=dtype)
        arr = {k.lower(): v for k, v in self.voxel_arrays.items()}

        dof_fixed, ext_force, ext_disp, ext_tdisp = apply_bc_regions(
            self.bcs, self.structure, self.lattice_dim
        )

        # VXA devo arrays are normalized genome outputs; map them to actual
        # sizes/times the way the reference does at import
        # (VX_Sim.cpp:878-965; see materials.devo_params_from_vxa)
        devo = devo_params_from_vxa(
            arr, self.sim, self.env, self.lattice_dim, self.structure
        )

        return build_body(
            self.structure,
            palette,
            lattice_dim=self.lattice_dim,
            phase_offset=arr.get("phaseoffset"),
            final_phase_offset=arr.get("finalphaseoffset"),
            temp_amp_damp=arr.get("tempampdamp"),
            final_temp_amp_damp=arr.get("finaltempampdamp"),
            stiffness=arr.get("stiffness"),
            stiffness_plasticity_rate=arr.get("stiffnessplasticityrate"),
            kp=arr.get("kp"),
            ki=arr.get("ki"),
            antiwindup=arr.get("antiwindup"),
            **devo,
            dof_fixed=dof_fixed,
            external_force=ext_force,
            external_disp=ext_disp,
            external_tdisp=ext_tdisp,
            dtype=dtype,
            device=device,
        )


def apply_bc_regions(bcs, structure, lattice_dim):
    """Rasterize BC regions onto the lattice.

    Reference semantics: a voxel belongs to a region if its center point is
    touching the region scaled to the workspace (VX_Sim.cpp Import →
    CVX_FRegion::GetRegion()->IsTouching with half-voxel envelope). Forces
    are divided equally among the voxels in the region
    (VX_Environment.cpp AddForcedBc usage in VX_Sim.cpp:488-722).
    """
    X, Y, Z = structure.shape
    occ = structure > 0
    if not bcs:
        return None, None, None, None

    ws = np.array([X, Y, Z], dtype=np.float64) * lattice_dim
    centers = (
        np.stack(
            np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij"),
            axis=-1,
        ).astype(np.float64)
        + 0.5
    ) * lattice_dim
    half = 0.5 * lattice_dim

    dof_fixed = np.zeros((X, Y, Z), dtype=np.int32)
    ext_force = np.zeros((X, Y, Z, 3))
    ext_disp = np.zeros((X, Y, Z, 3))
    ext_tdisp = np.zeros((X, Y, Z, 3))

    for bc in bcs:
        lo = np.array([bc.x, bc.y, bc.z]) * ws
        if bc.prim_type == PRIM_BOX:
            hi = lo + np.array([bc.dx, bc.dy, bc.dz]) * ws
            inside = np.all(
                (centers >= lo - half) & (centers <= hi + half), axis=-1
            )
        elif bc.prim_type == PRIM_SPHERE:
            r = bc.radius * ws.min()
            inside = np.linalg.norm(centers - lo, axis=-1) <= r + half
        elif bc.prim_type == PRIM_CYLINDER:
            r = bc.radius * ws.min()
            dxy = np.linalg.norm(centers[..., :2] - lo[:2], axis=-1)
            hi_z = lo[2] + bc.dz * ws[2]
            inside = (
                (dxy <= r + half)
                & (centers[..., 2] >= lo[2] - half)
                & (centers[..., 2] <= hi_z + half)
            )
        else:
            continue
        inside = inside & occ
        n = max(int(inside.sum()), 1)
        dof_fixed[inside] |= bc.dof_fixed
        ext_force[inside] += np.asarray(bc.force) / n
        ext_disp[inside] += np.asarray(bc.displace)
        ext_tdisp[inside] += np.asarray(bc.ang_displace)

    return dof_fixed, ext_force, ext_disp, ext_tdisp


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _text(el, tag, default=None, cast=float):
    child = el.find(tag) if el is not None else None
    if child is None or child.text is None:
        return default
    txt = child.text.strip()
    if cast is bool:
        return txt not in ("0", "", "false", "False")
    try:
        return cast(txt)
    except ValueError:
        return default


def _decode_layer(data: str, compression: str, n_expected: int) -> np.ndarray:
    """Decode one <Layer> CDATA string to per-voxel byte values.

    Mirrors the reference's compression dispatch
    (VX_Object.cpp:1748-1830 CVXC_Structure::ReadXML):

    - ``ASCII_READABLE``: one char per voxel, value = ord(ch) - 48
    - ``ZLIB``: base64 text wrapping a zlib stream of raw id bytes
    - ``QT_ZLIB`` (deprecated): base64 wrapping qCompress output, which
      prefixes the zlib stream with a 4-byte big-endian expected length
    - ``RAW_DATA`` (deprecated): raw id bytes stored as chars
    - ``BASE64`` / missing attribute: base64 of raw id bytes
      (the reference's fall-through default)

    Anything else raises instead of silently mis-parsing.
    """
    import base64
    import zlib

    if compression == "ASCII_READABLE":
        vals = np.frombuffer(data.encode("latin-1"), dtype=np.uint8)
        return vals.astype(np.int32) - 48
    if compression == "ZLIB":
        raw = zlib.decompress(base64.b64decode(data))
        return np.frombuffer(raw, dtype=np.uint8).astype(np.int32)
    if compression == "QT_ZLIB":
        blob = base64.b64decode(data)
        raw = zlib.decompress(blob[4:])  # skip qCompress length header
        return np.frombuffer(raw, dtype=np.uint8).astype(np.int32)
    if compression == "RAW_DATA":
        vals = np.frombuffer(data.encode("latin-1"), dtype=np.uint8)
        return vals.astype(np.int32)
    if compression in ("", "BASE64"):
        raw = base64.b64decode(data)
        return np.frombuffer(raw, dtype=np.uint8).astype(np.int32)
    raise ValueError(
        f"unknown VXC <Structure> Compression={compression!r} "
        f"(expected layer of {n_expected} voxels)"
    )


def _parse_layers_int(struct_el, tag, shape, compression="ASCII_READABLE"):
    """Parse per-voxel CDATA layers (material ids) honoring Compression."""
    X, Y, Z = shape
    out = np.zeros(shape, dtype=np.int32)
    el = struct_el.find(tag)
    if el is None:
        return None
    for z, layer in enumerate(el.findall("Layer")):
        data = (layer.text or "").strip()
        vals = _decode_layer(data, compression, X * Y)
        if vals.size != X * Y:
            raise ValueError(
                f"<{tag}> layer {z}: got {vals.size} voxels, expected {X * Y} "
                "(reference: VX_Object.cpp:1801 size check)"
            )
        # flat index = x + X*y (reference: read_write_voxelyze.py:353-357)
        out[:, :, z] = vals.reshape(Y, X).T
    return out


def _parse_layers_float(struct_el, tag, shape):
    """Parse comma-separated float CDATA layers (per-voxel arrays)."""
    X, Y, Z = shape
    el = struct_el.find(tag)
    if el is None:
        return None
    out = np.zeros(shape, dtype=np.float64)
    for z, layer in enumerate(el.findall("Layer")):
        txt = (layer.text or "").strip()
        vals = [v for v in re.split(r"[,\s]+", txt) if v]
        for i, v in enumerate(vals[: X * Y]):
            x, y = i % X, i // X
            out[x, y, z] = float(v)
    return out


def _parse_material(mat_el) -> Material:
    mech = mat_el.find("Mechanical")
    disp = mat_el.find("Display")
    rgba = (
        _text(disp, "Red", 0.5),
        _text(disp, "Green", 0.5),
        _text(disp, "Blue", 0.5),
        _text(disp, "Alpha", 1.0),
    )
    # MDL_DATA stress-strain point tables (reference: VX_Object.cpp:1368-1390)
    ss_strain: tuple = ()
    ss_stress: tuple = ()
    ssdata = mech.find("SSData") if mech is not None else None
    if ssdata is not None:
        n_pts = _text(ssdata, "NumDataPts", 0, cast=int)
        strain_el = ssdata.find("StrainData")
        stress_el = ssdata.find("StressData")
        if strain_el is not None and stress_el is not None:
            ss_strain = tuple(
                float(e.text) for e in strain_el.findall("Strain")[:n_pts]
            )
            ss_stress = tuple(
                float(e.text) for e in stress_el.findall("Stress")[:n_pts]
            )
    # compound-material type: explicit <MatType>, else the reference's
    # "detective work" fallback (VX_Object.cpp:1350-1355 ReadXML)
    mat_type = _text(mat_el, "MatType", None, cast=int)
    if mat_type is None:
        if mat_el.find("Structure") is not None:
            mat_type = 1  # INTERNAL
        elif mat_el.find("RandIndex1") is not None:
            mat_type = 3  # DITHER
        else:
            mat_type = 0  # SINGLE
    sub_structure = None
    sub_offset = (0, 0, 0)
    sub_rax = 0
    sub_ram = 0
    if mat_type == 1:
        sub_el = mat_el.find("Structure")
        if sub_el is not None:
            sx = _text(sub_el, "X_Voxels", 1, cast=int)
            sy = _text(sub_el, "Y_Voxels", 1, cast=int)
            sz = _text(sub_el, "Z_Voxels", 1, cast=int)
            sub_structure = _parse_layers_int(
                sub_el, "Data", (sx, sy, sz),
                sub_el.get("Compression", "ASCII_READABLE"))
        sub_offset = (
            _text(mat_el, "X_Offset", 0, cast=int),
            _text(mat_el, "Y_Offset", 0, cast=int),
            _text(mat_el, "Z_Offset", 0, cast=int),
        )
        sub_rax = _text(mat_el, "StructRotateAxis", 0, cast=int)
        sub_ram = _text(mat_el, "StructRotateAmount", 0, cast=int)
    return Material(
        id=int(mat_el.get("ID", "0")),
        name=_text(mat_el, "Name", "", cast=str),
        mat_type=mat_type,
        rand_index1=_text(mat_el, "RandIndex1", 0, cast=int),
        rand_index2=_text(mat_el, "RandIndex2", 0, cast=int),
        # the ReadXML default for a DITHER material missing PercIndex1 is 0
        # (VX_Object.cpp:1432), not the constructor's 0.5
        perc_index1=_text(mat_el, "PercIndex1",
                          0.0 if mat_type == 3 else 0.5),
        sub_structure=sub_structure,
        sub_offset=sub_offset,
        sub_rotate_axis=sub_rax,
        sub_rotate_amount=sub_ram,
        mat_model=_text(mech, "MatModel", 0, cast=int),
        ss_strain=ss_strain,
        ss_stress=ss_stress,
        elastic_mod=_text(mech, "Elastic_Mod", 1e7),
        plastic_mod=_text(mech, "Plastic_Mod", 0.0),
        yield_stress=_text(mech, "Yield_Stress", 0.0),
        fail_model=_text(mech, "FailModel", 0, cast=int),
        fail_stress=_text(mech, "Fail_Stress", 0.0),
        fail_strain=_text(mech, "Fail_Strain", 0.0),
        density=_text(mech, "Density", 1e6),
        poissons_ratio=_text(mech, "Poissons_Ratio", 0.35),
        cte=_text(mech, "CTE", 0.0),
        u_static=_text(mech, "uStatic", 1.0),
        u_dynamic=_text(mech, "uDynamic", 0.5),
        mat_temp_phase=_text(mat_el, "TempPhase", 0.0),
        rgba=rgba,
    )


def _prsm(x, y, z, k) -> float:
    """Pseudo-Random Spatial Map: combined Tausworthe-88 generator seeded by
    the float32 bit patterns of the coordinates (reference:
    VX_Object.cpp:2588-2636 rand_seed/taus_get/prsm). Bit-exact replication
    so a dithered VXA imports to the same per-voxel materials as the
    reference engine. Values stay below 2**32, so Python ints with explicit
    masks are exact."""
    import struct as _struct

    M32 = 0xFFFFFFFF

    def seed(v):
        return (1664525 * v + 1013904223) & 0x7FFFFFFF

    def taus(s1, s2, s3):
        b = (((s1 << 13) & M32) ^ s1) >> 19
        s1 = (((s1 & 0xFFFFFFFE) << 12) & M32) ^ b
        b = (((s2 << 2) & M32) ^ s2) >> 25
        s2 = (((s2 & 0xFFFFFFF8) << 4) & M32) ^ b
        b = (((s3 << 3) & M32) ^ s3) >> 11
        s3 = (((s3 & 0xFFFFFFF0) << 17) & M32) ^ b
        return s1, s2, s3

    ts1, ts2, ts3 = (
        int.from_bytes(_struct.pack("<f", float(v)), "little")
        for v in (x, y, z)
    )
    s1, s2, s3 = seed(ts1), seed(ts2), seed(ts3)
    for _ in range(2):
        s1 = seed(s1 ^ s3)
        s2 = seed(s2 ^ s1)
        s3 = seed(s3 ^ s2)
    for _ in range(int(k) + 10):
        s1, s2, s3 = taus(s1, s2, s3)
    return (s1 ^ s2 ^ s3) / 4294967295.0


def resolve_leaf_material_ids(structure, materials):
    """Resolve each voxel's structure id to its leaf SINGLE material id,
    replicating CVX_Object::GetLeafMatIndex (reference: VX_Object.cpp:722-735
    + GetSubMatIndex 815-872) as applied at sim import (VX_Sim.cpp:534).

    INTERNAL materials tile their sub-structure over rotated/offset nominal
    coordinates; DITHER materials pick rand_index1 with probability
    perc_index1 via the prsm spatial hash, else rand_index2. Chains resolve
    up to 100 deep (the reference's infinite-recursion guard), then 0."""
    by_id = {m.id: m for m in materials}
    if not any(m.mat_type != 0 for m in materials):
        return structure
    out = np.array(structure, dtype=np.int32, copy=True)
    for idx in np.argwhere(structure > 0):
        x, y, z = (int(v) for v in idx)
        last = int(structure[x, y, z])
        for _ in range(100):
            m = by_id.get(last)
            if m is None or last <= 0:
                last = 0
                break
            if m.mat_type == 0:  # SINGLE
                break
            if m.mat_type == 3:  # DITHER
                r = _prsm(x, y, z, m.rand_index1 + m.rand_index2)
                nxt = m.rand_index1 if r < m.perc_index1 else m.rand_index2
            elif m.mat_type == 1 and m.sub_structure is not None:  # INTERNAL
                # rotation about the axis, then offset, then tile (mod)
                rx, ry, rz = x, y, z
                ax, am = m.sub_rotate_axis, m.sub_rotate_amount
                if am != 0:
                    if ax == 0:  # RAX_X
                        if am == 1:
                            ry, rz = rz, -ry - 1
                        elif am == 2:
                            ry, rz = -ry - 1, -rz - 1
                        else:
                            ry, rz = -rz - 1, ry
                    elif ax == 1:  # RAX_Y
                        if am == 1:
                            rx, rz = -rz - 1, rx
                        elif am == 2:
                            rx, rz = -rx - 1, -rz - 1
                        else:
                            rx, rz = rz, -rx - 1
                    else:  # RAX_Z
                        if am == 1:
                            rx, ry = ry, -rx - 1
                        elif am == 2:
                            rx, ry = -rx - 1, -ry - 1
                        else:
                            rx, ry = -ry - 1, rx
                sx, sy, sz = m.sub_structure.shape
                rx = (rx - m.sub_offset[0]) % sx
                ry = (ry - m.sub_offset[1]) % sy
                rz = (rz - m.sub_offset[2]) % sz
                # the transformed coordinates carry into deeper levels
                # (GetSubMatIndex mutates them by pointer)
                x, y, z = rx, ry, rz
                nxt = int(m.sub_structure[rx, ry, rz])
            else:
                nxt = last  # malformed INTERNAL defaults to itself
            if nxt == last:
                break
            last = nxt
        else:
            last = 0  # >100 hops: treated as infinite recursion
        out[idx[0], idx[1], idx[2]] = last
    return out


def _parse_regions(env_el) -> list:
    bcs = []
    for container, count_tag in (
        ("Boundary_Conditions", "NumBCs"),
        ("Fixed_Regions", "NumFixed"),
        ("Forced_Regions", "NumForced"),
    ):
        cel = env_el.find(container)
        if cel is None:
            continue
        for reg in cel.findall("FRegion"):
            dof = _text(reg, "DofFixed", None, cast=int)
            if dof is None:
                fixed = _text(reg, "Fixed", False, cast=bool)
                dof = DOF_ALL if fixed else 0
            bcs.append(
                BCRegion(
                    prim_type=_text(reg, "PrimType", PRIM_BOX, cast=int),
                    x=_text(reg, "X", 0.0),
                    y=_text(reg, "Y", 0.0),
                    z=_text(reg, "Z", 0.0),
                    dx=_text(reg, "dX", 0.0),
                    dy=_text(reg, "dY", 0.0),
                    dz=_text(reg, "dZ", 0.0),
                    radius=_text(reg, "Radius", 0.0),
                    dof_fixed=dof,
                    force=(
                        _text(reg, "ForceX", 0.0),
                        _text(reg, "ForceY", 0.0),
                        _text(reg, "ForceZ", 0.0),
                    ),
                    torque=(
                        _text(reg, "TorqueX", 0.0),
                        _text(reg, "TorqueY", 0.0),
                        _text(reg, "TorqueZ", 0.0),
                    ),
                    displace=(
                        _text(reg, "DisplaceX", 0.0),
                        _text(reg, "DisplaceY", 0.0),
                        _text(reg, "DisplaceZ", 0.0),
                    ),
                    ang_displace=(
                        _text(reg, "AngDisplaceX", 0.0),
                        _text(reg, "AngDisplaceY", 0.0),
                        _text(reg, "AngDisplaceZ", 0.0),
                    ),
                )
            )
    return bcs


def load_vxa(path) -> VXADocument:
    """Parse a .vxa file into a VXADocument.

    Defaults replicate the reference's ReadXML fallbacks
    (VX_Sim.cpp:263-356, VX_Environment.cpp:123-298).
    """
    tree = ET.parse(path)
    root = tree.getroot()

    # ---- Simulator ----
    sim_el = root.find("Simulator")
    integ = sim_el.find("Integration") if sim_el is not None else None
    damp = sim_el.find("Damping") if sim_el is not None else None
    cols = sim_el.find("Collisions") if sim_el is not None else None
    stop = sim_el.find("StopCondition") if sim_el is not None else None
    ga = sim_el.find("GA") if sim_el is not None else None
    feat = sim_el.find("Features") if sim_el is not None else None
    equil = sim_el.find("EquilibriumMode") if sim_el is not None else None

    stop_type = _text(stop, "StopConditionType", SC_MAX_SIM_TIME, cast=int)
    stop_value = _text(stop, "StopConditionValue", 5.0)

    sim = SimParams(
        dt_frac=_text(integ, "DtFrac", 0.9),
        bond_damping_z=_text(damp, "BondDampingZ", 0.1),
        col_damping_z=_text(damp, "ColDampingZ", 1.0),
        slow_damping_z=_text(damp, "SlowDampingZ", 1.0),
        stop_condition_value=stop_value,
        init_cm_time=_text(stop, "InitCmTime", 0.0),
        afterlife_time=_text(stop, "AfterlifeTime", 0.0),
        mid_life_freeze_time=_text(stop, "MidLifeFreezeTime", 0.0),
        parent_lifetime=_text(sim_el, "ParentLifetime", 0.0),
        min_temp_fact=_text(sim_el, "MinTempFact", 0.1),
        max_temp_fact_change=_text(sim_el, "MaxTempFactChange", 0.00015),
        max_stiffness_change=_text(sim_el, "MaxStiffnessChange", 0.00015),
        min_elastic_mod=_text(sim_el, "MinElasticMod", 5e6),
        max_elastic_mod=_text(sim_el, "MaxElasticMod", 5e8),
        max_kp=_text(sim_el, "MaxKP", 5.0),
        max_ki=_text(sim_el, "MaxKI", 1.0),
        max_antiwindup=_text(sim_el, "MaxANTIWINDUP", 1.0),
        error_threshold=_text(sim_el, "ErrorThreshold", 0.1),
        threshold_time=_text(sim_el, "ThresholdTime", 2.0),
        max_vox_vel_limit=_text(feat, "MaxVoxVelLimit", 0.1),
        self_collisions_enabled=_text(cols, "SelfColEnabled", False, cast=bool),
        collision_horizon=_text(cols, "CollisionHorizon", 2.0),
        max_velocity_enabled=_text(feat, "MaxVelLimitEnabled", False, cast=bool),
        volume_effects_enabled=_text(
            feat, "VolumeEffectsEnabled", False, cast=bool
        ),
        equilibrium_mode=_text(
            equil, "EquilibriumModeEnabled", False, cast=bool
        ),
    )

    # ---- Environment ----
    env_el = root.find("Environment")
    grav = env_el.find("Gravity") if env_el is not None else None
    therm = env_el.find("Thermal") if env_el is not None else None

    temp_base = _text(therm, "TempBase", 25.0)
    temp_amplitude = _text(therm, "TempAmplitude", None)
    if temp_amplitude is None:
        # legacy TempAmp = peak temperature → amplitude = peak − base
        # (reference: VX_Environment.cpp:184-189)
        temp_amp = _text(therm, "TempAmp", None)
        temp_amplitude = (temp_amp - temp_base) if temp_amp is not None else 0.0

    floor_radius = _text(env_el, "FloorRadius", None)
    bcs = _parse_regions(env_el) if env_el is not None else []

    # environmental sources (reference: VX_Environment.cpp:241-285)
    sources = None
    src_el = env_el.find("Sources") if env_el is not None else None
    if src_el is not None:
        from evosoro_tpu_torch.envs.sources import make_sources

        entries = []
        for s in src_el.findall("Source"):
            entries.append(dict(
                name=_text(s, "SourceName", "NoNameSource", cast=str),
                type=_text(s, "SourceType", 0, cast=int),
                enabled=_text(s, "SourceEnabled", False, cast=bool),
                pos=(_text(s, "SourcePositionX", 0.0),
                     _text(s, "SourcePositionY", 0.0),
                     _text(s, "SourcePositionZ", 0.0)),
                amp=(_text(s, "SourceMotionAmpX", 0.0),
                     _text(s, "SourceMotionAmpY", 0.0),
                     _text(s, "SourceMotionAmpZ", 0.0)),
                freq=(_text(s, "SourceMotionFreqX", 0.0),
                      _text(s, "SourceMotionFreqY", 0.0),
                      _text(s, "SourceMotionFreqZ", 0.0)),
            ))
        sources = make_sources(entries)

    # dormant <NeuralNet> block: parse-and-carry only, exactly as the
    # reference does (VX_Environment.cpp:197-206 — no engine reader exists)
    neural_net = None
    nn_el = env_el.find("NeuralNet") if env_el is not None else None
    if nn_el is not None:
        neural_net = NeuralNetParams(
            updates_per_temp_cycle=_text(
                nn_el, "NeuralNetUpdatesPerTempCycle", 0.0
            ),
            touch_sensors_enabled=_text(
                nn_el, "TouchSensorsEnabled", False, cast=bool
            ),
            proprioception_sensors_enabled=_text(
                nn_el, "ProprioceptionSensorsEnabled", False, cast=bool
            ),
            pacemaker_sensors_enabled=_text(
                nn_el, "PacemakerSensorsEnabled", False, cast=bool
            ),
            num_hidden_neurons_per_layer=_text(
                nn_el, "NumHiddenNeuronsPerLayer", 0, cast=int
            ),
            num_hidden_layers=_text(nn_el, "NumHiddenLayers", 0, cast=int),
            output_smoothing=_text(nn_el, "OutputSmoothing", 0.0),
        )

    env = EnvParams(
        grav_acc=_text(grav, "GravAcc", -9.81),
        floor_slope=_text(grav, "FloorSlope", 0.0),
        temp_base=temp_base,
        temp_amplitude=temp_amplitude,
        temp_period=_text(therm, "TempPeriod", 0.1),
        growth_amplitude=_text(env_el, "GrowthAmplitude", 0.0),
        min_growth_time=_text(env_el, "MinGrowthTime", 0.0),
        ballistic_slowdown_fact=_text(env_el, "BallisticSlowdownFact", 0.01),
        max_slowdown_permitted=_text(env_el, "MaxSlowdownPermitted", 0.1),
        num_trace_steps_in_window=_text(
            env_el, "NumTimeStepsInWindow", 0, cast=int
        ),
        time_between_traces=_text(env_el, "TimeBetweenTraces", 0.01),
        normalization_exponent=_text(env_el, "NormalizationExponent", 1.0),
        norm_dist_by_vol=_text(env_el, "NormDistByVol", False, cast=bool),
        falling_prohibited=_text(env_el, "FallingProhibited", False, cast=bool),
        needle_in_haystack=_text(env_el, "NeedleInHaystack", False, cast=bool),
        onset_relative=_text(env_el, "OnsetRelative", False, cast=bool),
        termination_relative=_text(
            env_el, "TerminationRelative", False, cast=bool
        ),
        floor_radius=floor_radius if floor_radius is not None else 0.0,
        sources=sources,
        neural_net=neural_net,
        aggregate_drag_coefficient=_text(
            env_el, "AggregateDragCoefficient", 0.0
        ),
        gravity_enabled=_text(grav, "GravEnabled", False, cast=bool),
        floor_enabled=_text(grav, "FloorEnabled", False, cast=bool),
        floor_limited=floor_radius is not None,
        temp_enabled=_text(therm, "TempEnabled", False, cast=bool),
        vary_temp_enabled=_text(therm, "VaryTempEnabled", False, cast=bool),
        sticky_floor=_text(env_el, "StickyFloor", False, cast=bool),
        fluid_environment=_text(env_el, "FluidEnvironment", False, cast=bool),
    )

    # ---- VXC ----
    vxc = root.find("VXC")
    lattice = vxc.find("Lattice")
    lattice_dim = _text(lattice, "Lattice_Dim", 0.001)
    env = env.replace(lattice_dim=lattice_dim)

    palette_el = vxc.find("Palette")
    materials = [_parse_material(m) for m in palette_el.findall("Material")]

    struct_el = vxc.find("Structure")
    X = _text(struct_el, "X_Voxels", 1, cast=int)
    Y = _text(struct_el, "Y_Voxels", 1, cast=int)
    Z = _text(struct_el, "Z_Voxels", 1, cast=int)
    compression = struct_el.get("Compression", "")
    structure = _parse_layers_int(struct_el, "Data", (X, Y, Z), compression)
    if structure is None:
        structure = np.zeros((X, Y, Z), dtype=np.int32)
    # ids must fit the palette's id space; palettes may have non-contiguous
    # IDs (the ID attribute is authoritative), so bound by max id, not count
    max_id = max((m.id for m in materials), default=0)
    if structure.min() < 0 or structure.max() > max_id:
        raise ValueError(
            f"VXC structure has material ids outside palette "
            f"[0, {max_id}]: range "
            f"[{int(structure.min())}, {int(structure.max())}]"
        )
    # resolve compound (INTERNAL/DITHER) palette entries to leaf SINGLE
    # materials per voxel, exactly as the sim does at import
    # (VX_Sim.cpp:534 GetLeafMatIndex); no-op for all-SINGLE palettes
    structure = resolve_leaf_material_ids(structure, materials)

    voxel_arrays = {}
    for tag in VOXEL_ARRAY_TAGS:
        arr = _parse_layers_float(struct_el, tag, (X, Y, Z))
        if arr is not None:
            voxel_arrays[tag] = arr

    return VXADocument(
        sim=sim,
        env=env,
        lattice_dim=lattice_dim,
        materials=materials,
        structure=structure,
        voxel_arrays=voxel_arrays,
        bcs=bcs,
        stop_condition_type=stop_type,
        stop_condition_value=stop_value,
        fitness_file_name=_text(ga, "FitnessFileName", "", cast=str),
        write_fitness_file=_text(ga, "WriteFitnessFile", False, cast=bool),
        save_traces=_text(env_el, "SaveTraces", False, cast=bool),
        time_between_traces=_text(env_el, "TimeBetweenTraces", 0.0),
        norm_dist_by_vol=_text(env_el, "NormDistByVol", False, cast=bool),
        normalization_exponent=_text(env_el, "NormalizationExponent", 1.0),
        falling_prohibited=_text(env_el, "FallingProhibited", False, cast=bool),
        needle_in_haystack=_text(env_el, "NeedleInHaystack", False, cast=bool),
    )


# ---------------------------------------------------------------------------
# Writing (mirrors tools/read_write_voxelyze.py:40-407)
# ---------------------------------------------------------------------------



# ---------------------------------------------------------------------------
# Writing (mirrors tools/read_write_voxelyze.py:40-407)
# ---------------------------------------------------------------------------

def _layers_int(arr, compression: str = "ASCII_READABLE") -> str:
    """Encode material-id layers; mirrors VX_Object.cpp:1658-1706 WriteXML."""
    import base64
    import zlib

    X, Y, Z = arr.shape
    out = []
    for z in range(Z):
        flat = np.asarray(arr[:, :, z]).T.reshape(-1).astype(np.uint8)
        if compression == "ASCII_READABLE":
            data = (flat + 48).tobytes().decode("latin-1")
        elif compression == "ZLIB":
            data = base64.b64encode(zlib.compress(flat.tobytes())).decode()
        elif compression == "BASE64":
            data = base64.b64encode(flat.tobytes()).decode()
        else:
            raise ValueError(f"unsupported write Compression={compression!r}")
        out.append(f"<Layer><![CDATA[{data}]]></Layer>")
    return "\n".join(out)


def _layers_float(arr) -> str:
    X, Y, Z = arr.shape
    out = []
    for z in range(Z):
        vals = "".join(
            f"{arr[x, y, z]}, " for y in range(Y) for x in range(X)
        )
        out.append(f"<Layer><![CDATA[{vals}]]></Layer>")
    return "\n".join(out)


def _material_xml(m: Material) -> str:
    temp_phase = (
        f"<TempPhase>{m.mat_temp_phase}</TempPhase>\n" if m.mat_temp_phase else ""
    )
    ssdata = ""
    if m.ss_strain:
        # reference writer: VX_Object.cpp:1299-1310 (SSData precedes the
        # scalar fields inside <Mechanical>)
        strains = "\n".join(f"<Strain>{v}</Strain>" for v in m.ss_strain)
        stresses = "\n".join(f"<Stress>{v}</Stress>" for v in m.ss_stress)
        ssdata = (
            f"<SSData>\n<NumDataPts>{len(m.ss_strain)}</NumDataPts>\n"
            f"<StrainData>\n{strains}\n</StrainData>\n"
            f"<StressData>\n{stresses}\n</StressData>\n</SSData>\n"
        )
    return f"""<Material ID="{m.id}">
<MatType>0</MatType>
<Name>{m.name}</Name>
{temp_phase}<Display>
<Red>{m.rgba[0]}</Red>
<Green>{m.rgba[1]}</Green>
<Blue>{m.rgba[2]}</Blue>
<Alpha>{m.rgba[3]}</Alpha>
</Display>
<Mechanical>
<MatModel>{m.mat_model}</MatModel>
{ssdata}<Elastic_Mod>{m.elastic_mod}</Elastic_Mod>
<Plastic_Mod>{m.plastic_mod}</Plastic_Mod>
<Yield_Stress>{m.yield_stress}</Yield_Stress>
<FailModel>{m.fail_model}</FailModel>
<Fail_Stress>{m.fail_stress}</Fail_Stress>
<Fail_Strain>{m.fail_strain}</Fail_Strain>
<Density>{m.density}</Density>
<Poissons_Ratio>{m.poissons_ratio}</Poissons_Ratio>
<CTE>{m.cte}</CTE>
<uStatic>{m.u_static}</uStatic>
<uDynamic>{m.u_dynamic}</uDynamic>
</Mechanical>
</Material>"""


def write_vxa(
    path,
    structure,
    materials,
    sim: Optional[SimParams] = None,
    env: Optional[EnvParams] = None,
    voxel_arrays: Optional[dict] = None,
    fitness_file_name: str = "",
    stop_condition_type: int = SC_MAX_SIM_TIME,
    self_col_enabled: Optional[bool] = None,
    save_traces: bool = False,
    time_between_traces: float = 0.0,
    extra_env_tags: str = "",
    lattice_dim: Optional[float] = None,
    compression: str = "ASCII_READABLE",
):
    """Write a .vxa the reference `voxelyze` binary accepts unmodified."""
    sim = sim or SimParams()
    env = env or EnvParams()
    if lattice_dim is not None:
        env = env.replace(lattice_dim=float(lattice_dim))
    voxel_arrays = voxel_arrays or {}
    structure = np.asarray(structure)
    X, Y, Z = structure.shape
    if self_col_enabled is None:
        self_col_enabled = sim.self_collisions_enabled

    ga_block = ""
    if fitness_file_name:
        ga_block = f"""<GA>
<WriteFitnessFile>1</WriteFitnessFile>
<FitnessFileName>{fitness_file_name}</FitnessFileName>
</GA>
"""

    sources_block = ""
    if getattr(env, "sources", None) is not None:
        import numpy as _np

        s = env.sources
        rows = []
        for k in range(int(_np.asarray(s.base_pos).shape[0])):
            bp = _np.asarray(s.base_pos)[k]
            am = _np.asarray(s.amp)[k]
            fq = _np.asarray(s.freq)[k]
            rows.append(
                "<Source>\n"
                f"<SourceType>{int(_np.asarray(s.source_type)[k])}</SourceType>\n"
                f"<SourceEnabled>{int(bool(_np.asarray(s.enabled)[k]))}</SourceEnabled>\n"
                f"<SourcePositionX>{bp[0]}</SourcePositionX>\n"
                f"<SourcePositionY>{bp[1]}</SourcePositionY>\n"
                f"<SourcePositionZ>{bp[2]}</SourcePositionZ>\n"
                f"<SourceMotionAmpX>{am[0]}</SourceMotionAmpX>\n"
                f"<SourceMotionFreqX>{fq[0]}</SourceMotionFreqX>\n"
                f"<SourceMotionAmpY>{am[1]}</SourceMotionAmpY>\n"
                f"<SourceMotionFreqY>{fq[1]}</SourceMotionFreqY>\n"
                f"<SourceMotionAmpZ>{am[2]}</SourceMotionAmpZ>\n"
                f"<SourceMotionFreqZ>{fq[2]}</SourceMotionFreqZ>\n"
                "</Source>"
            )
        sources_block = "<Sources>\n" + "\n".join(rows) + "\n</Sources>\n"

    neural_block = ""
    nn = getattr(env, "neural_net", None)
    if nn is not None:
        neural_block = (
            "<NeuralNet>\n"
            f"<NeuralNetUpdatesPerTempCycle>{nn.updates_per_temp_cycle}"
            "</NeuralNetUpdatesPerTempCycle>\n"
            f"<TouchSensorsEnabled>{int(nn.touch_sensors_enabled)}"
            "</TouchSensorsEnabled>\n"
            f"<ProprioceptionSensorsEnabled>"
            f"{int(nn.proprioception_sensors_enabled)}"
            "</ProprioceptionSensorsEnabled>\n"
            f"<PacemakerSensorsEnabled>{int(nn.pacemaker_sensors_enabled)}"
            "</PacemakerSensorsEnabled>\n"
            f"<NumHiddenNeuronsPerLayer>{nn.num_hidden_neurons_per_layer}"
            "</NumHiddenNeuronsPerLayer>\n"
            f"<NumHiddenLayers>{nn.num_hidden_layers}</NumHiddenLayers>\n"
            f"<OutputSmoothing>{nn.output_smoothing}</OutputSmoothing>\n"
            "</NeuralNet>\n"
        )

    trace_tags = ""
    if save_traces:
        trace_tags = (
            f"<SaveTraces>1</SaveTraces>\n"
            f"<TimeBetweenTraces>{time_between_traces}</TimeBetweenTraces>\n"
        )

    mats = "\n".join(_material_xml(m) for m in materials)
    arrays = "\n".join(
        f"<{tag}>\n{_layers_float(np.asarray(arr))}\n</{tag}>"
        for tag, arr in voxel_arrays.items()
    )

    body = f"""<?xml version="1.0" encoding="ISO-8859-1"?>
<VXA Version="1.0">
<Simulator>
<Integration>
<Integrator>0</Integrator>
<DtFrac>{sim.dt_frac}</DtFrac>
</Integration>
<Damping>
<BondDampingZ>{sim.bond_damping_z}</BondDampingZ>
<ColDampingZ>{sim.col_damping_z}</ColDampingZ>
<SlowDampingZ>{sim.slow_damping_z}</SlowDampingZ>
</Damping>
<Collisions>
<SelfColEnabled>{int(self_col_enabled)}</SelfColEnabled>
<ColSystem>3</ColSystem>
<CollisionHorizon>{sim.collision_horizon}</CollisionHorizon>
</Collisions>
<Features>
<MaxVelLimitEnabled>{int(sim.max_velocity_enabled)}</MaxVelLimitEnabled>
<MaxVoxVelLimit>{sim.max_vox_vel_limit}</MaxVoxVelLimit>
<FluidDampEnabled>0</FluidDampEnabled>
<VolumeEffectsEnabled>{int(sim.volume_effects_enabled)}</VolumeEffectsEnabled>
<EnforceLatticeEnabled>0</EnforceLatticeEnabled>
</Features>
<SurfMesh>
<CMesh>
<DrawSmooth>1</DrawSmooth>
<Vertices/>
<Facets/>
<Lines/>
</CMesh>
</SurfMesh>
<StopCondition>
<StopConditionType>{stop_condition_type}</StopConditionType>
<StopConditionValue>{sim.stop_condition_value}</StopConditionValue>
<InitCmTime>{sim.init_cm_time}</InitCmTime>
<AfterlifeTime>{sim.afterlife_time}</AfterlifeTime>
<MidLifeFreezeTime>{sim.mid_life_freeze_time}</MidLifeFreezeTime>
<ParentLifetime>{sim.parent_lifetime or sim.stop_condition_value}</ParentLifetime>
</StopCondition>
<EquilibriumMode>
<EquilibriumModeEnabled>{int(sim.equilibrium_mode)}</EquilibriumModeEnabled>
</EquilibriumMode>
{ga_block}<MinTempFact>{sim.min_temp_fact}</MinTempFact>
<MaxTempFactChange>{sim.max_temp_fact_change}</MaxTempFactChange>
<MaxStiffnessChange>{sim.max_stiffness_change}</MaxStiffnessChange>
<MinElasticMod>{sim.min_elastic_mod}</MinElasticMod>
<MaxElasticMod>{sim.max_elastic_mod}</MaxElasticMod>
<MaxKP>{sim.max_kp}</MaxKP>
<MaxKI>{sim.max_ki}</MaxKI>
<MaxANTIWINDUP>{sim.max_antiwindup}</MaxANTIWINDUP>
<ErrorThreshold>{sim.error_threshold}</ErrorThreshold>
<ThresholdTime>{sim.threshold_time}</ThresholdTime>
</Simulator>
<Environment>
<Fixed_Regions>
<NumFixed>0</NumFixed>
</Fixed_Regions>
<Forced_Regions>
<NumForced>0</NumForced>
</Forced_Regions>
<Gravity>
<GravEnabled>{int(env.gravity_enabled)}</GravEnabled>
<GravAcc>{env.grav_acc}</GravAcc>
<FloorEnabled>{int(env.floor_enabled)}</FloorEnabled>
<FloorSlope>{env.floor_slope}</FloorSlope>
</Gravity>
<Thermal>
<TempEnabled>{int(env.temp_enabled)}</TempEnabled>
<TempAmp>{env.temp_base + env.temp_amplitude}</TempAmp>
<TempBase>{env.temp_base}</TempBase>
<VaryTempEnabled>{int(env.vary_temp_enabled)}</VaryTempEnabled>
<TempPeriod>{env.temp_period}</TempPeriod>
</Thermal>
{neural_block}<GrowthAmplitude>{env.growth_amplitude}</GrowthAmplitude>
<MinGrowthTime>{env.min_growth_time}</MinGrowthTime>
<BallisticSlowdownFact>{env.ballistic_slowdown_fact}</BallisticSlowdownFact>
<MaxSlowdownPermitted>{env.max_slowdown_permitted}</MaxSlowdownPermitted>
<NumTimeStepsInWindow>{env.num_trace_steps_in_window}</NumTimeStepsInWindow>
<NormDistByVol>{int(env.norm_dist_by_vol)}</NormDistByVol>
<NormalizationExponent>{env.normalization_exponent}</NormalizationExponent>
<FallingProhibited>{int(env.falling_prohibited)}</FallingProhibited>
<NeedleInHaystack>{int(env.needle_in_haystack)}</NeedleInHaystack>
<OnsetRelative>{int(env.onset_relative)}</OnsetRelative>
<TerminationRelative>{int(env.termination_relative)}</TerminationRelative>
<StickyFloor>{int(env.sticky_floor)}</StickyFloor>
<FluidEnvironment>{int(env.fluid_environment)}</FluidEnvironment>
<AggregateDragCoefficient>{env.aggregate_drag_coefficient}</AggregateDragCoefficient>
{sources_block}{trace_tags}{extra_env_tags}</Environment>
<VXC Version="0.93">
<Lattice>
<Lattice_Dim>{env.lattice_dim}</Lattice_Dim>
<X_Dim_Adj>1</X_Dim_Adj>
<Y_Dim_Adj>1</Y_Dim_Adj>
<Z_Dim_Adj>1</Z_Dim_Adj>
<X_Line_Offset>0</X_Line_Offset>
<Y_Line_Offset>0</Y_Line_Offset>
<X_Layer_Offset>0</X_Layer_Offset>
<Y_Layer_Offset>0</Y_Layer_Offset>
</Lattice>
<Voxel>
<Vox_Name>BOX</Vox_Name>
<X_Squeeze>1</X_Squeeze>
<Y_Squeeze>1</Y_Squeeze>
<Z_Squeeze>1</Z_Squeeze>
</Voxel>
<Palette>
{mats}
</Palette>
<Structure Compression="{compression}">
<X_Voxels>{X}</X_Voxels>
<Y_Voxels>{Y}</Y_Voxels>
<Z_Voxels>{Z}</Z_Voxels>
<Data>
{_layers_int(structure, compression)}
</Data>
{arrays}
</Structure>
</VXC>
</VXA>
"""
    with open(path, "w") as f:
        f.write(body)
    return path


def read_fitness_xml(path) -> dict:
    """Parse a Voxelyze_Sim_Result fitness XML into {tag: float}
    (reference output: VX_SimGA.cpp:140-203; reference parser:
    read_write_voxelyze.py:7-37)."""
    tree = ET.parse(path)
    root = tree.getroot()
    out = {}

    def walk(el):
        for child in el:
            if len(child):
                walk(child)
            elif child.text is not None:
                txt = child.text.strip()
                try:
                    out[child.tag] = float(txt)
                except ValueError:
                    out[child.tag] = txt

    walk(root)
    return out
