"""Write `evaluation_jax.npz`: the JAX package's evaluator (its eager path,
`EVOSORO_TPU_FUSED_EVAL=0`) on the populations of
tests/test_torch_evaluation.py's `test_evaluate_all_matches_jax` and
`test_experiments_match_jax` (basic, the swimmers under the facet and the
voxel-face drag, swimming_complex, growth), for those tests to hold the
port against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_evaluation_jax.py

Takes about two minutes. Stores, for each case, a digest of its Sim and
Env settings (`jax_outputs.inputs_digest` of `_settings_key`), each
individual's phenotype md5 (what the port's population must match) and
fitness. Rewrite it whenever a case, the genome code or the JAX package's
evaluator or step changes.
"""

import os
import sys

import jax

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the tests

from jax_outputs import save  # noqa: E402
from test_torch_evaluation import (  # noqa: E402
    _EXPERIMENTS,
    EVALUATION_FIXTURE,
    _jax_generation,
    _settings_key,
)


def main():
    out = save(EVALUATION_FIXTURE, {case: ((_settings_key(case),), _jax_generation(case))
                                    for case in ("basic", *_EXPERIMENTS)})
    print({k: v.tolist() for k, v in out.items() if k.endswith("fitness")})


if __name__ == "__main__":
    main()
