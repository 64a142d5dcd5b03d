"""Write `materials_kernel_jax.npz`: the JAX package's fused kernel in
interpret mode on the case of tests/test_torch_materials.py's
`test_fused_materials_match_jax_kernel`, for that test to hold
the port against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_materials_kernel_jax.py

Takes under a minute: the kernel's compile in interpret mode. Stores a
digest of the inputs (`jax_outputs.inputs_digest`) and the outputs.
Rewrite it whenever the case or the JAX package's kernel changes.
"""

import os
import sys

import jax

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the tests

from jax_outputs import save  # noqa: E402
from test_torch_materials import MATERIALS_FIXTURE, materials_kernel_jax  # noqa: E402


def main():
    out = save(MATERIALS_FIXTURE, dict(kernel=materials_kernel_jax()))
    print({k: v.shape for k, v in out.items()})


if __name__ == "__main__":
    main()
