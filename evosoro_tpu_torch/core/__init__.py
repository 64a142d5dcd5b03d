"""Voxel lattice physics on torch tensors: containers, materials, the eager
step and the rollout helpers."""

from evosoro_tpu_torch.core.collision import (  # noqa: F401
    CollisionSystem,
    build_collision_system,
    collision_forces,
)
from evosoro_tpu_torch.core.materials import (  # noqa: F401
    build_body,
    calc_max_dt,
    devo_params_from_vxa,
    palette_from_list,
)
from evosoro_tpu_torch.core.rollout import (  # noqa: F401
    RolloutResult,
    center_of_mass,
    init_state,
    num_steps_for,
    rollout,
    total_volume,
)
from evosoro_tpu_torch.core.step import sim_step  # noqa: F401
from evosoro_tpu_torch.core.types import (  # noqa: F401
    DevoState,
    EnvParams,
    Material,
    MaterialPalette,
    SimParams,
    SimState,
    VoxelBody,
    evosoro_default_palette,
)
