"""evosoro_tpu_torch: the PyTorch and CUDA port of `evosoro_tpu`.

A second package beside the JAX one, laid out the same way (`core`, `ops`,
`evo`, `io`, `utils`) so each module's counterpart is easy to find. It
imports torch and never jax; the JAX package is the reference the tests hold
it against. On an NVIDIA Hopper card the rollout runs through hand-written
CUDA kernels (`ops/csrc`); on CPU tensors the same entry points run their
plain PyTorch versions.

Ported so far: the evolution loop's evaluation (`evo`), sampling MPC
(`control.shooting`) and gradient MPC (`control.grad_optimize`,
`control.sqp`, `ops.fused_diff`), whose fused solver differentiates the
rollout with the reverse-mode segment kernel inside
`ops.fused_rollout.diff_envelope_ok`: the fused kernel's envelope without
self-collision.
"""

__version__ = "0.1.0"

from evosoro_tpu_torch.core import (  # noqa: F401
    EnvParams,
    Material,
    MaterialPalette,
    RolloutResult,
    SimParams,
    SimState,
    VoxelBody,
    build_body,
    calc_max_dt,
    center_of_mass,
    evosoro_default_palette,
    init_state,
    num_steps_for,
    palette_from_list,
    rollout,
    sim_step,
)
from evosoro_tpu_torch.core.constants import (  # noqa: F401
    DEFAULT_PRECISION,
    PREC_HIGH,
    PREC_LOW,
    PREC_MED,
    Precision,
)
