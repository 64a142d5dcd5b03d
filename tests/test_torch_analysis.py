"""The port's static analysis (`evosoro_tpu_torch.analysis`) held against
the analytic beam values of tests/test_fea.py at its tolerances, and
against the JAX package's `fea_solve`, `tensile_test` and the jvp of its
elastic loads on the same inputs, in float64.

Both packages build their bodies from the same numpy inputs. JAX's side is
jitted CG, a few seconds a case to compile, so it is read from
`tests/fixtures/viz_analysis_jax.npz` after checking a digest of those
inputs (`tests/jax_outputs.py`); rewrite it with
`JAX_PLATFORMS=cpu python tests/fixtures/make_viz_analysis_jax.py` whenever
a case or either package's step changes. The two packages' CG run the same
iteration in other orders of summation: displacement, rotation, force and
stress are held at rtol 1e-9, and the operator's matvec, which has no
iteration to amplify an ulp, at rtol 1e-10.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.types import Material as JMaterial
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu_torch.analysis import fea_solve, linear_operator, tensile_test
from evosoro_tpu_torch.core import Material, build_body, palette_from_list
from evosoro_tpu_torch.core.types import evosoro_default_palette
from jax_outputs import stored

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "viz_analysis_jax.npz")
JAX_RTOL = 1e-9
MATVEC_RTOL = 1e-10
E, L = 1e6, 0.001


def _beam(n, clamped=True):
    """tests/test_fea.py's beam: n voxels along x, the root clamped, as
    (structure, dof_fixed)."""
    structure = np.zeros((n, 1, 1), dtype=np.int32)
    structure[:, 0, 0] = 1
    fixed = np.zeros((n, 1, 1), dtype=np.int32)
    if clamped:
        fixed[0, 0, 0] = 63  # all 6 DOF
    return structure, fixed


def fea_case(case):
    """(structure, dof_fixed, load or strains) of a case of
    tests/test_fea.py; the beams are of one material of modulus E and
    density 1e3 at pitch L, in float64."""
    if case == "cantilever":
        n, P = 10, 1e-4
        ext = np.zeros((n, 1, 1, 3))
        ext[-1, 0, 0, 2] = -P  # tip load in -z
        return (*_beam(n), ext)
    if case == "axial":
        n, P = 6, 1e-3
        ext = np.zeros((n, 1, 1, 3))
        ext[-1, 0, 0, 0] = P  # axial pull
        return (*_beam(n), ext)
    return (*_beam(6, clamped=False), np.array([0.005, 0.01]))


FEA_CASES = ("cantilever", "axial", "tensile")
FEA_KEYS = dict(cantilever=("displacement", "rotation", "residual"),
                axial=("displacement", "rotation", "residual"),
                tensile=("force", "stress", "stiffness"))


def _jax_beam(structure, fixed):
    pal = j_palette([JMaterial(1, elastic_mod=E, density=1e3)])
    return j_build_body(structure, pal, lattice_dim=L, dof_fixed=fixed, dtype=jnp.float64)


def _port_beam(structure, fixed):
    pal = palette_from_list([Material(1, elastic_mod=E, density=1e3)])
    return build_body(structure, pal, lattice_dim=L, dof_fixed=fixed, dtype=torch.float64)


def fea_jax(case):
    """JAX's outputs of a case (for the fixture)."""
    from evosoro_tpu.analysis import fea_solve as j_fea_solve
    from evosoro_tpu.analysis import tensile_test as j_tensile_test

    structure, fixed, arg = fea_case(case)
    jb = _jax_beam(structure, fixed)
    if case == "tensile":
        out = jax.jit(lambda: j_tensile_test(jb, axis=0, strains=arg))()
    else:
        out = jax.jit(lambda: j_fea_solve(jb, ext_force=arg, tol=1e-12))()
    return {k: np.asarray(out[k]) for k in FEA_KEYS[case]}


def matvec_case():
    """A random 3x3x2 design of the default palette (every bond direction,
    heterogeneous bonds) and a random (u, w) with shear and torsion."""
    rng = np.random.default_rng(5)
    structure = rng.integers(1, 5, size=(3, 3, 2)).astype(np.int32)
    u = rng.normal(size=(3, 3, 2, 3)) * 1e-4
    w = rng.normal(size=(3, 3, 2, 3)) * 1e-2
    return structure, u, w


def matvec_jax():
    from evosoro_tpu.analysis.fea import linear_operator as j_linear_operator

    structure, u, w = matvec_case()
    jb = j_build_body(structure, j_palette(j_default_palette()), dtype=jnp.float64)
    f, m = j_linear_operator(jb)(jnp.asarray(u), jnp.asarray(w))
    return dict(f=np.asarray(f), m=np.asarray(m))


def _port_run(case):
    structure, fixed, arg = fea_case(case)
    body = _port_beam(structure, fixed)
    if case == "tensile":
        return tensile_test(body, axis=0, strains=arg)
    return fea_solve(body, ext_force=arg, tol=1e-12)


@pytest.fixture(scope="module")
def port():
    """The port's output of each case, computed once."""
    return {case: _port_run(case) for case in FEA_CASES}


def test_cantilever_tip_deflection_matches_analytic(port):
    n, P = 10, 1e-4
    sol = port["cantilever"]
    tip = float(sol["displacement"][-1, 0, 0, 2])
    I = L ** 4 / 12.0  # noqa: E741
    analytic = -P * ((n - 1) * L) ** 3 / (3.0 * E * I)
    assert abs(tip - analytic) / abs(analytic) < 1e-6
    assert float(sol["residual"]) < 1e-10
    assert sol["displacement"].dtype == torch.float64 and sol["iterations"] > 0


def test_axial_stretch_matches_spring_series(port):
    n, P = 6, 1e-3
    tip = float(port["axial"]["displacement"][-1, 0, 0, 0])
    k = E * L * L / L / (n - 1)  # a series of n - 1 springs EA/L
    assert abs(tip - P / k) / (P / k) < 1e-8


def test_tensile_test_recovers_elastic_modulus(port):
    out = port["tensile"]
    stress, strain = out["stress"].numpy(), out["strain"].numpy()
    np.testing.assert_allclose(stress / strain, E, rtol=1e-6)
    np.testing.assert_allclose(stress[1], 2 * stress[0], rtol=1e-8)  # linearity
    assert len(out["iterations"]) == 2


@pytest.mark.parametrize("case", FEA_CASES)
def test_fea_matches_jax(port, case):
    ref = stored(FIXTURE, "fea_" + case, *fea_case(case))
    for k in FEA_KEYS[case]:
        got = port[case][k].numpy()
        if k == "residual":  # both at round-off: a bound, not a value
            assert got < 1e-10 and ref[k] < 1e-10
        elif k == "rotation" and case == "axial":  # zero in both
            assert np.abs(got).max() < 1e-12 and np.abs(ref[k]).max() < 1e-12
        else:
            np.testing.assert_allclose(got, ref[k], rtol=JAX_RTOL,
                                       atol=JAX_RTOL * np.abs(ref[k]).max(), err_msg=k)


def test_linear_operator_matches_jax_jvp():
    structure, u, w = matvec_case()
    ref = stored(FIXTURE, "matvec", structure, u, w)
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      dtype=torch.float64)
    f, m = linear_operator(body)(torch.as_tensor(u), torch.as_tensor(w))
    for got, want in ((f, ref["f"]), (m, ref["m"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=MATVEC_RTOL,
                                   atol=MATVEC_RTOL * np.abs(want).max())
