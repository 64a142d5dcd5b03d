"""Write `eager_bptt_jax.npz`: `jax.grad` through the JAX package's jnp
`rollout` in float64 on each case of
tests/test_torch_fused_diff.py::test_eager_bptt_float64_matches_jax_grad,
for that test to hold the port's eager BPTT against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_eager_bptt_jax.py

Takes ~3 min on an 8-core host: JAX's trace and compile of each case's
gradient. Stores, per case, a digest of what the gradient was taken on
(`inputs_digest` of the start state, the body, the sim and env
parameters, the dt and the controls)
and the gradient by the knots. Rewrite it whenever a case or the JAX
package's step changes.
"""

import os
import sys

import jax
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the tests

from jax_outputs import inputs_digest  # noqa: E402
from test_torch_fused_diff import (  # noqa: E402
    BPTT_CASES,
    BPTT_FIXTURE,
    bptt_case,
    bptt_jax_grad,
)


def main():
    out = {}
    for case in BPTT_CASES:
        state, jb, sim, env, dt, u0 = bptt_case(case)
        out[case + "/inputs"] = np.asarray(inputs_digest(state, jb, sim, env, dt, u0))
        out[case + "/grad"] = bptt_jax_grad(state, jb, sim, env, dt, u0)
        print(case, out[case + "/grad"].shape, flush=True)
    np.savez_compressed(BPTT_FIXTURE, **out)


if __name__ == "__main__":
    main()
