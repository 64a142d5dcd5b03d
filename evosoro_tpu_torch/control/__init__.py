"""Model-predictive control over batched soft-body rollouts.

The port of `evosoro_tpu.control`: the per-voxel control sequence of the
rollout's actuation channel is optimized online by shooting.

- `cem_optimize`: derivative-free Cross-Entropy Method through the eager
  rollout: sample candidates, roll them out as one batch, refit a Gaussian
  to the elites.
- `cem_optimize_fused`, `make_fused_cem_solver`: the same solve through the
  fused rollout kernel, one launch per iteration.
- `MPCController` / `mpc_run`, `make_fused_mpc_closed_loop`: receding-horizon
  drivers: plan from the current state, execute the first control segment,
  replan.
- `grad_optimize`: first-order shooting, Adam on the rollout cost by
  backpropagation through the eager rollout (torch autograd).
- `sqp_optimize`, `sqp_optimize_multistart`, `locomotion_sqp`: projected
  Gauss-Newton/LM tracking of a CoM profile through the eager rollout
  (forward- and reverse-mode products, matrix-free CG).
- `FusedSQPSolver`, `sqp_optimize_fused`: the same solve through the fused
  kernels: segments of K1 forward and the reverse-mode segment kernel B4
  backward. Its envelope is `ops.fused_rollout.diff_envelope_ok`: K1's
  envelope on land, in water (voxel-face or facet drag) and with the
  development ramps, without self-collision, volume effects, plasticity
  and the other material options, the fitness features, sources and BC
  regions (volume effects raise ValueError there, as in the JAX package).
"""

from evosoro_tpu_torch.control.shooting import (  # noqa: F401
    CEMConfig,
    CEMState,
    MPCController,
    cem_optimize,
    cem_optimize_fused,
    cem_sample,
    cem_update,
    grad_optimize,
    locomotion_cost,
    make_fused_cem_solver,
    make_fused_mpc_closed_loop,
    mpc_run,
)
from evosoro_tpu_torch.control.sqp import (  # noqa: F401
    FusedSQPSolver,
    SQPConfig,
    locomotion_sqp,
    sqp_optimize,
    sqp_optimize_fused,
    sqp_optimize_multistart,
)
