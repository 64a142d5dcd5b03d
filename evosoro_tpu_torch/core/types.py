"""Config and state containers for the voxel physics core, as dataclasses.

The layout follows `evosoro_tpu.core.types` field for field, so the two
packages can be compared channel by channel: structure-of-arrays over the
full bounding lattice with an occupancy mask. Per-voxel tensors are
`(..., X, Y, Z)`, vectors `(..., X, Y, Z, 3)`, per-bond tensors
`(..., 3, X, Y, Z)` with axis -4 indexing the bond direction. A leading
batch shape `...` is allowed everywhere; per-robot scalars (time, dt,
divergence latch) then have that batch shape.

Parameter provenance (reference files of skriegman/evosoro):
- SimParams  <- VXA <Simulator> block (base.py:21-47, VX_Sim.cpp:263-356)
- EnvParams  <- VXA <Environment> block (base.py:50-74, VX_Environment.cpp:123-298)
- Material   <- VXC <Palette><Material> (VX_Object.h:525-660)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# DOF bit flags (reference: VX_FRegion.h:32-42)
DOF_X, DOF_Y, DOF_Z, DOF_TX, DOF_TY, DOF_TZ = 1, 2, 4, 8, 16, 32
DOF_ALL = 63

# Material models (reference: VX_Object.h MatModel enum)
MDL_LINEAR, MDL_LINEAR_FAIL, MDL_BILINEAR, MDL_DATA = 0, 1, 2, 3

# Failure models (reference: VX_Object.h FailModel enum)
FM_MAXSTRESS, FM_MAXSTRAIN = 0, 1


class _Replace:
    """`x.replace(field=value)`, the flax-struct idiom the JAX package uses."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device):
        """A copy with every tensor field on `device`."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if torch.is_tensor(getattr(self, f.name))}
        return dataclasses.replace(self, **moved)


@dataclasses.dataclass
class SimParams(_Replace):
    """Integration/damping/stop-condition parameters.

    Defaults follow what evosoro's writer emits for every experiment
    (reference: tools/read_write_voxelyze.py:62-117). Scalars may be Python
    floats or tensors of the batch shape; the feature switches are bools.
    """

    dt_frac: Any = 0.9
    bond_damping_z: Any = 1.0
    col_damping_z: Any = 0.8
    slow_damping_z: Any = 0.01
    stop_condition_value: Any = 5.0  # seconds of sim time (SC_MAX_SIM_TIME)
    init_cm_time: Any = 1.0  # actuation + CoM capture start
    min_temp_fact: Any = 0.1  # lower bound on voxel scale / nominal
    max_vox_vel_limit: Any = 0.1
    afterlife_time: Any = 0.0
    mid_life_freeze_time: Any = 0.0
    parent_lifetime: Any = 0.0

    # parsed-for-parity engine parameters the live dynamics never read
    # (VX_Sim.cpp:335-351); kept so VXA files round-trip
    max_temp_fact_change: Any = 0.00015
    max_stiffness_change: Any = 0.00015
    min_elastic_mod: Any = 5e6
    max_elastic_mod: Any = 5e8
    kp: Any = 3.0
    ki: Any = 0.001
    antiwindup: Any = 0.5
    max_kp: Any = 5.0
    max_ki: Any = 1.0
    max_antiwindup: Any = 1.0
    error_threshold: Any = 0.1
    threshold_time: Any = 2.0

    # feature switches (reference: VXSFEAT_* flags, VX_Sim.h)
    self_collisions_enabled: bool = False
    max_velocity_enabled: bool = False
    volume_effects_enabled: bool = False
    plasticity_enabled: bool = False
    equilibrium_mode: bool = False
    collision_horizon: Any = 2.0


@dataclasses.dataclass
class EnvParams(_Replace):
    """Environment: gravity, floor, thermal actuation drive, fluid.

    (reference: base.py:50-74 defaults; VX_Environment.cpp:123-298 parsing)
    """

    grav_acc: Any = -9.81
    floor_slope: Any = 0.0
    temp_base: Any = 25.0
    temp_amplitude: Any = 39.0
    temp_period: Any = 0.25
    growth_amplitude: Any = 0.0
    min_growth_time: Any = 0.0
    ballistic_slowdown_fact: Any = 0.01
    max_slowdown_permitted: Any = 0.1
    floor_radius: Any = 0.0
    aggregate_drag_coefficient: Any = 0.0
    time_between_traces: Any = 0.01
    normalization_exponent: Any = 1.0
    num_trace_steps_in_window: int = 0
    norm_dist_by_vol: bool = False
    falling_prohibited: bool = False
    needle_in_haystack: bool = False
    onset_relative: bool = False
    termination_relative: bool = False

    gravity_enabled: bool = True
    floor_enabled: bool = True
    floor_limited: bool = False
    temp_enabled: bool = True
    vary_temp_enabled: bool = True
    sticky_floor: bool = False
    fluid_environment: bool = False
    lattice_dim: Any = 0.01
    sources: Any = None
    neural_net: Any = None


@dataclasses.dataclass(frozen=True)
class Material:
    """One palette entry (reference: VX_Object.h:525-660 CVXC_Material)."""

    id: int
    name: str = ""
    elastic_mod: float = 1e7
    density: float = 1e6
    poissons_ratio: float = 0.35
    cte: float = 0.0
    u_static: float = 1.0
    u_dynamic: float = 0.5
    mat_model: int = MDL_LINEAR
    plastic_mod: float = 0.0
    yield_stress: float = 0.0
    fail_model: int = 0
    fail_stress: float = 0.0
    fail_strain: float = 0.0
    mat_temp_phase: float = 0.0
    rgba: tuple = (0.5, 0.5, 0.5, 1.0)
    ss_strain: tuple = ()
    ss_stress: tuple = ()
    mat_type: int = 0  # SINGLE
    rand_index1: int = 0
    rand_index2: int = 0
    perc_index1: float = 0.5
    sub_structure: Any = None
    sub_offset: tuple = (0, 0, 0)
    sub_rotate_axis: int = 0
    sub_rotate_amount: int = 0


def validate_ss_data(mat: Material) -> Material:
    """Replicate ValidateSSData (reference: VX_Object.cpp:1545-1605): check
    the point series and derive the scalar material fields from it."""
    xs = tuple(float(v) for v in mat.ss_strain)
    ys = tuple(float(v) for v in mat.ss_stress)
    if len(xs) < 2 or len(ys) < 2:
        raise ValueError("MDL_DATA needs more than one stress-strain point")
    if len(xs) != len(ys):
        raise ValueError("strain and stress vectors are unequal length")
    if xs[0] != 0.0:
        raise ValueError("first stress-strain point must be (0, 0)")
    for a, b in zip(xs, xs[1:]):
        if a >= b:
            raise ValueError("strain values must be strictly increasing")
    n = len(xs)
    elastic_mod = ys[1] / xs[1]
    mo, bo = elastic_mod, -0.002 * elastic_mod
    yield_stress = ys[-1]
    for i in range(1, n - 1):
        x1, x2, y1, y2 = xs[i], xs[i + 1], ys[i], ys[i + 1]
        mt = (y2 - y1) / (x2 - x1)
        bt = y1 - mt * x1
        if mo != mt:
            xint = (bt - bo) / (mo - mt)
            if x1 < xint < x2:
                yield_stress = y1 + (xint - x1) / (x2 - x1) * (y2 - y1)
                break
    return dataclasses.replace(
        mat,
        ss_strain=xs,
        ss_stress=ys,
        elastic_mod=elastic_mod,
        plastic_mod=elastic_mod,
        fail_stress=0.0,
        fail_strain=xs[-1],
        fail_model=FM_MAXSTRAIN,
        yield_stress=yield_stress,
    )


@dataclasses.dataclass
class MaterialPalette(_Replace):
    """Palette as tensors indexed by material id (0 = empty)."""

    elastic_mod: Any
    density: Any
    poisson: Any
    cte: Any
    u_static: Any
    u_dynamic: Any
    mat_model: Any
    plastic_mod: Any
    yield_stress: Any
    fail_stress: Any
    fail_strain: Any
    mat_temp_phase: Any
    num_materials: int = 0
    ss_strain: Any = None  # (n_mat, P) MDL_DATA point tables
    ss_stress: Any = None
    ss_last_slope: Any = None
    ss_last_stress: Any = None


def evosoro_default_palette(
    fat_stiffness=5e6,
    bone_stiffness=5e8,
    muscle_stiffness=5e6,
    actuation_cte=0.01,
):
    """The 7-material palette every evosoro experiment hard-codes
    (reference: tools/read_write_voxelyze.py:175-344)."""
    return [
        Material(1, "Passive_Soft", fat_stiffness, cte=0.0, rgba=(0, 1, 1, 1)),
        Material(2, "Passive_Hard", bone_stiffness, cte=0.0, rgba=(0, 0, 1, 1)),
        Material(3, "Active_+", muscle_stiffness, cte=actuation_cte, rgba=(1, 0, 0, 1)),
        Material(4, "Active_-", muscle_stiffness, cte=-actuation_cte, rgba=(0, 1, 0, 1)),
        Material(5, "Obstacle", 5e7, cte=0.0, rgba=(1, 0.784, 0, 1)),
        Material(6, "Head_Active_+", fat_stiffness, cte=actuation_cte, rgba=(1, 1, 0, 1)),
        Material(7, "Food", muscle_stiffness, cte=0.0, rgba=(1, 1, 0, 1)),
    ]


@dataclasses.dataclass
class VoxelBody(_Replace):
    """Static (per-design) tensors precomputed once per phenotype.

    Per-bond tensors are `(..., 3, X, Y, Z)`: the bond at `(d, x, y, z)`
    connects voxel (x,y,z) to its +d neighbour; boundary/missing bonds are
    masked. See `evosoro_tpu.core.types.VoxelBody` for each field's
    reference provenance.
    """

    occ: Any
    mat: Any
    nom_pos: Any
    nominal_size: Any  # Python float lattice pitch [m]

    mass: Any
    mass_inv: Any
    inertia: Any
    inertia_inv: Any
    first_moment: Any
    e_mod: Any
    poisson: Any
    cte: Any
    u_static: Any
    u_dynamic: Any
    lin_stiffness: Any
    two_sq_mexs: Any
    two_sq_iexsss: Any

    phase_offset: Any
    final_phase_offset: Any
    temp_amp_damp: Any
    final_temp_amp_damp: Any
    initial_voxel_size: Any
    final_voxel_size: Any
    growth_time: Any
    start_growth_time: Any

    dof_fixed: Any
    external_force: Any
    external_disp: Any
    external_tdisp: Any

    bond_mask: Any
    bond_homogeneous: Any
    bond_e: Any
    bond_e1: Any
    bond_e2: Any
    bond_a1: Any
    bond_a2: Any
    bond_b1: Any
    bond_b2: Any
    bond_b3: Any
    d_a1m1: Any
    d_a1m2: Any
    d_a2i1: Any
    d_a2i2: Any
    d_b1m1: Any
    d_b1m2: Any
    d_b2fm1: Any
    d_b2fm2: Any
    d_b3i1: Any
    d_b3i2: Any

    # self-collision: a `core.collision.CollisionSystem`, or a dense
    # (..., V, V) pair-stiffness tensor in flat x-major voxel order
    collision: Any = None
    mesh_drag: Any = None

    plastic_mod: Any = None
    yield_stress: Any = None
    mat_temp_phase: Any = None
    mat_model_vox: Any = None

    ss_strain_vox: Any = None
    ss_stress_vox: Any = None
    ss_fail_strain_vox: Any = None
    ss_last_stress_vox: Any = None
    ss_last_slope_vox: Any = None

    stiffness_plasticity_rate: Any = None
    kp: Any = None
    ki: Any = None
    antiwindup: Any = None

    bond_u: Any = None
    bond_eh: Any = None

    all_linear: bool = True

    using_phase_offset: bool = True
    using_final_phase_offset: bool = False
    using_temp_amp_damp: bool = False
    using_final_temp_amp_damp: bool = False
    using_initial_voxel_size: bool = False
    using_final_voxel_size: bool = False
    using_growth_time: bool = False
    using_start_growth_time: bool = False

    @property
    def grid_shape(self):
        return tuple(self.occ.shape[-3:])

    @property
    def num_voxels(self):
        return self.occ.sum(dim=(-3, -2, -1))


@dataclasses.dataclass
class SimState(_Replace):
    """Dynamic state of one rollout, or of a batch of them.

    Mirrors CVXS_Voxel state (VXS_Voxel.h) + CVXS_Bond damping memory
    (VX_Bond.h _LastPos2/_LastAngle1/_LastAngle2) + the plasticity
    high-water marks. The volume-effects and ballistic-devo carries of the
    JAX package are outside this port's envelope and stay None.
    """

    pos: Any
    quat: Any
    linmom: Any
    angmom: Any
    scale: Any
    last_scale: Any

    small_angle: Any
    last_pos2: Any
    last_angle1: Any
    last_angle2: Any
    max_strain: Any
    strain_offset: Any

    time: Any
    diverged: Any

    ke_history: Any

    ts_sum: Any = None
    cs_area: Any = None
    cur_dt: Any = None
    devo: Any = None

    total_strain_e: Any = None
    max_vox_vel: Any = None
