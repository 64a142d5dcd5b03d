"""Write `viz_analysis_jax.npz`: the JAX package's side of
tests/test_torch_analysis.py (`fea_solve` and `tensile_test` on the beams of
tests/test_fea.py, the jvp of the elastic loads on a random body),
tests/test_torch_viz.py (`record_trajectory` on each case, the renderer's
surface), tests/test_torch_sandbox.py (the sandbox after 5 steps, a poke and
60 steps) and tests/test_torch_onchip_parity.py (the 12 scenarios of
tools/onchip_parity.py, flattened).

    JAX_PLATFORMS=cpu python tests/fixtures/make_viz_analysis_jax.py

Takes ~2 min on an 8-core host: the jits of the CG solves, the trajectory
scans and the sandbox step, and the scenario builders' op-by-op compiles.
Stores each case beside a digest of its inputs (`jax_outputs.save`);
rewrite it whenever a case, the JAX tool or either package's step changes.
"""

import os
import sys

import jax

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the tests

import test_torch_analysis as analysis  # noqa: E402
import test_torch_onchip_parity as parity  # noqa: E402
import test_torch_sandbox as sandbox  # noqa: E402
import test_torch_viz as viz  # noqa: E402
from jax_outputs import save  # noqa: E402


def main():
    cases = {}
    for case in analysis.FEA_CASES:
        cases["fea_" + case] = (analysis.fea_case(case), analysis.fea_jax(case))
    cases["matvec"] = (analysis.matvec_case(), analysis.matvec_jax())
    for case in viz.TRAJ_CASES:
        cases["traj_" + case] = (viz.traj_inputs(case), viz.traj_jax(case))
    cases["surface"] = (viz.surface_case(), viz.surface_jax())
    cases["sandbox"] = (sandbox.sandbox_inputs(), sandbox.sandbox_jax())
    for name in parity.onchip_parity.SCENARIOS:
        cases["scenario_" + name] = (parity.scenario_inputs(name), parity.scenario_jax(name))
    for case in cases:
        print(case, sorted(cases[case][1]), flush=True)
    save(os.path.join(HERE, "viz_analysis_jax.npz"), cases)


if __name__ == "__main__":
    main()
