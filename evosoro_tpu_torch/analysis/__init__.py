"""Static analysis tools (the reference's VX_FEA capability): matrix-free
FEA over the eager step's bond forces and the tensile test."""

from evosoro_tpu_torch.analysis.fea import fea_solve, linear_operator  # noqa: F401
from evosoro_tpu_torch.analysis.tensile import tensile_test  # noqa: F401
