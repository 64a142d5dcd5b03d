"""Write `fused_diff_kernels_jax.npz`: the JAX package's `DiffRollout`
kernels (forward and backward, interpret mode) on the cases of
tests/test_torch_fused_diff.py's `test_segmented_forward_matches_full_and_jax`
(three 8-step segments of a 4^3 design) and
`test_fused_bwd_call_matches_jax_kernel` (the backward kernel at rest and 4
steps in), for those tests to hold the port against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_fused_diff_kernels_jax.py

Takes about a minute: the kernels' compiles in interpret mode. Stores what
the kernels were given (the packed body, the stats rows, the packed start
state, the controls and the cotangent) and what they returned. Rewrite it
whenever a case or either package's kernels or packing change.
"""

import os
import sys

import jax
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the tests

from test_torch_fused_diff import (  # noqa: E402
    BWD_CASES,
    KERNELS_FIXTURE,
    fused_bwd_jax_case,
    segmented_jax_case,
)


def main():
    out = {"segmented/" + k: v for k, v in segmented_jax_case().items()}
    for case, (pre_steps, seg_base) in BWD_CASES.items():
        out.update({f"{case}/{k}": v for k, v in fused_bwd_jax_case(pre_steps,
                                                                    seg_base).items()})
    np.savez_compressed(KERNELS_FIXTURE, **out)
    print({k: v.shape for k, v in out.items()})


if __name__ == "__main__":
    main()
