"""Model-predictive control over batched soft-body rollouts.

The port of `evosoro_tpu.control`'s sampling solvers: the per-voxel control
sequence of the rollout's actuation channel is optimized online by shooting.

- `cem_optimize`: derivative-free Cross-Entropy Method through the eager
  rollout: sample candidates, roll them out as one batch, refit a Gaussian
  to the elites.
- `cem_optimize_fused`, `make_fused_cem_solver`: the same solve through the
  fused rollout kernel, one launch per iteration.
- `MPCController` / `mpc_run`, `make_fused_mpc_closed_loop`: receding-horizon
  drivers: plan from the current state, execute the first control segment,
  replan.

The gradient solvers (`grad_optimize`, `control/sqp.py`) are not ported yet.
"""

from evosoro_tpu_torch.control.shooting import (  # noqa: F401
    CEMConfig,
    CEMState,
    MPCController,
    cem_optimize,
    cem_optimize_fused,
    cem_sample,
    cem_update,
    locomotion_cost,
    make_fused_cem_solver,
    make_fused_mpc_closed_loop,
    mpc_run,
)
