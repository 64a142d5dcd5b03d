"""Visualization off the optimization path. The port has the marching
tetrahedra mesher (`marching`), which `io.mesh_io.export_smooth_mesh`
needs."""

from evosoro_tpu_torch.viz.marching import (  # noqa: F401
    marching_tetrahedra,
    smooth_structure_mesh,
)
