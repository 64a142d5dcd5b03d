"""Write `roofline_walks_jax.npz`: the jaxpr walks (`tools/roofline.py`'s
`_count_jaxpr`) of the JAX package's step and its vjp that
tests/test_torch_roofline.py's
`test_adjoint_operation_counts_in_water_and_with_growth_are_jaxpr_walks` and
`test_material_adjoint_operation_counts_are_jaxpr_walks` hold the port's
operation counts against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_roofline_walks_jax.py

Takes about a minute: tracing only, nothing is compiled. Stores, per test, a
digest of the designs the walks were taken on (`designs_digest`) and the
counts. Rewrite it whenever a design or the JAX package's step changes.
"""

import os
import sys

import jax
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the tests

from test_torch_roofline import (  # noqa: E402
    WALKS_FIXTURE,
    designs_digest,
    material_designs,
    material_walks,
    water_growth_designs,
    water_growth_walks,
)


def main():
    structure, phase, growth, swimmers = water_growth_designs()
    out = {"water_growth/designs": np.asarray(designs_digest(structure, phase, *growth,
                                                             *swimmers))}
    out.update({"water_growth/" + k: np.asarray(v) for k, v in water_growth_walks().items()})
    structure, phase, _, params = material_designs()
    out["materials/designs"] = np.asarray(designs_digest(structure, phase, params))
    out.update({"materials/" + k: np.asarray(v) for k, v in material_walks().items()})
    np.savez_compressed(WALKS_FIXTURE, **out)
    print({k: v.tolist() for k, v in out.items()})


if __name__ == "__main__":
    main()
