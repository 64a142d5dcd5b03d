"""Visualization off the optimization path, the VoxCad-GUI analog: the
marching tetrahedra mesher (`marching`, which `io.mesh_io` uses),
trajectory recording through K1 or the eager step (`trajectory`), headless
rendering of the deformed surface mesh to PNG and GIF (`render`, which
imports matplotlib only when it draws), and the interactive sandbox
(`InteractiveSandbox`, `python -m evosoro_tpu_torch.viz.sandbox
design.vxa`)."""

from evosoro_tpu_torch.viz.marching import (  # noqa: F401
    marching_tetrahedra,
    smooth_structure_mesh,
)
from evosoro_tpu_torch.viz.render import (  # noqa: F401
    material_colors,
    render_state,
    save_animation,
)
from evosoro_tpu_torch.viz.sandbox import InteractiveSandbox  # noqa: F401
from evosoro_tpu_torch.viz.trajectory import record_trajectory  # noqa: F401
