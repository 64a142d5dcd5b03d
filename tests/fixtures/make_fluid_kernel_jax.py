"""Write `fluid_kernel_jax.npz`: the JAX package's fused rollout kernel in
interpret mode on both cases of
tests/test_torch_fluid.py::test_fused_fluid_rollout_matches_jax_kernel (the
voxel-face and the facet drag), for that test to hold the port against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_fluid_kernel_jax.py

Takes about a minute: the kernel's compiles in interpret mode. Stores a
digest of the inputs (`jax_outputs.inputs_digest`) and the kernel's outputs.
Rewrite it whenever a case or the JAX package's kernel changes.
"""

import os
import sys

import jax

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the tests

from jax_outputs import save  # noqa: E402
from test_torch_fluid import FLUID_FIXTURE, fluid_kernel_jax  # noqa: E402


def main():
    out = save(FLUID_FIXTURE, {model: fluid_kernel_jax(model) for model in ("face", "mesh")})
    print({k: v.shape for k, v in out.items()})


if __name__ == "__main__":
    main()
