"""Write `sqp_iteration_jax.npz`: one Gauss-Newton iteration of the JAX
package's `FusedSQPSolver` (its forward and backward kernels in interpret
mode) on the configuration of
tests/test_torch_sqp.py::test_fused_iteration_matches_jax_solver, for that
test to hold the port against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_sqp_iteration_jax.py

Takes a few minutes on an 8-core host: the interpret-mode compile of the
solve program. Stores what the kernels were given (the packed body, the
stats rows, the packed start state, the dt and the start controls) and what
the solve returned (the cost trace, the final cost, the accept decisions and
the controls after the step). Rewrite it whenever the case, either
package's kernels or packing, or the solver change.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the tests

from evosoro_tpu.control import sqp as j_sqp  # noqa: E402
from evosoro_tpu.core.rollout import init_state as j_init_state  # noqa: E402
from evosoro_tpu.core.types import EnvParams as JEnv  # noqa: E402
from evosoro_tpu.core.types import SimParams as JSim  # noqa: E402
from test_torch_sqp import SQP_FIXTURE, sqp_iteration_case  # noqa: E402


def main():
    jb, _, dt, steps, K, n_res, cfg, u0 = sqp_iteration_case()
    solver = j_sqp.FusedSQPSolver(jb, JSim(init_cm_time=0.0), JEnv(), steps, K,
                                  config=j_sqp.SQPConfig(**cfg), dt=dt, n_res=n_res,
                                  interpret=True)
    u, info = solver.solve(target=0.05, init_u=jnp.asarray(u0))
    dr = solver._dr
    V = int(np.prod(jb.occ.shape))  # the JAX layout pads the voxel axis to 128 lanes
    state0 = j_init_state(jb)
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (dr.batch,) + x.shape), state0)
    out = dict(u0=u0, dt=np.asarray(dt), body=np.asarray(dr.body_packed)[..., :V],
               stats0=np.asarray(dr.stats0), start=np.asarray(dr.init_packed(batched))[..., :V],
               cost_trace=np.asarray(info["cost_trace"]),
               final_cost=np.asarray(info["final_cost"]),
               accepted_trace=np.asarray(info["accepted_trace"]), u=np.asarray(u))
    np.savez_compressed(SQP_FIXTURE, **out)
    print({k: v.shape for k, v in out.items()})


if __name__ == "__main__":
    main()
