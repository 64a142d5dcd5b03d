"""Write `diff_gradients_jax.npz`: the JAX package's `DiffRollout` (its
forward and backward kernels in interpret mode) on the configuration of
tests/test_torch_fused_diff.py::test_diff_gradients_match_jax_backward_kernel,
for that test to hold the port against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_diff_gradients_jax.py

Takes a few minutes on an 8-core host: the interpret-mode compile of the
backward kernel. Stores what the kernels were given (the packed body, the
stats rows, the packed start state, the dt and the controls) and what they
returned: the last CoM-y of robot 0 and its gradient by the knots. Rewrite
it whenever the case or either package's kernels or packing change.
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

from evosoro_tpu.ops.fused_diff import DiffRollout as JDiffRollout  # noqa: E402
from test_torch_fused_diff import B, DIFF_FIXTURE, diff_gradients_case  # noqa: E402


def main():
    batched, jb, sim, env, dt, steps, K, n_segs, u0 = diff_gradients_case()
    jdr = JDiffRollout(jb, sim, env, num_steps=steps, num_knots=K, dt=dt, batch=B,
                       n_segs=n_segs, interpret=True)
    jsp = jdr.init_packed(batched)

    def f(u):
        cms, _, _ = jdr(jsp, jdr.stats0, jdr.pack_controls(
            jnp.broadcast_to(u[None], (B,) + u.shape)))
        return cms[-1, 0]

    value, grad = jax.value_and_grad(f)(jnp.asarray(u0))
    V = int(np.prod(jb.occ.shape))  # the JAX layout pads the voxel axis to 128 lanes
    out = dict(u0=u0, dt=np.asarray(dt), body=np.asarray(jdr.body_packed)[..., :V],
               stats0=np.asarray(jdr.stats0), start=np.asarray(jsp)[..., :V],
               value=np.asarray(value), grad=np.asarray(grad))
    np.savez_compressed(DIFF_FIXTURE, **out)
    print({k: v.shape for k, v in out.items()})


if __name__ == "__main__":
    main()
