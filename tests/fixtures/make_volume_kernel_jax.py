"""Write `volume_kernel_jax.npz`: the JAX package's fused kernel with
volume effects in interpret mode on the cases of tests/test_torch_volume.py's
`test_fused_volume_matches_jax_kernel` (8 x 4^3, 80 steps) and
`test_fused_volume_staggered_stops_match_jax_kernel` (40 steps, a stop time
per robot), for those tests to hold the port against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_volume_kernel_jax.py

Takes about a minute: the kernel's compiles in interpret mode. Stores a
digest of the inputs (`jax_outputs.inputs_digest`) and the outputs. Rewrite
it whenever a case or the JAX package's kernel changes.
"""

import os
import sys

import jax

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the tests

from jax_outputs import save  # noqa: E402
from test_torch_volume import VOLUME_FIXTURE, staggered_jax, volume_kernel_jax  # noqa: E402


def main():
    out = save(VOLUME_FIXTURE, dict(kernel=volume_kernel_jax(), staggered=staggered_jax()))
    print({k: v.shape for k, v in out.items()})


if __name__ == "__main__":
    main()
