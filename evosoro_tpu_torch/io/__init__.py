"""IO: the VXA (VoxCad XML) reader and writer for reference interop, and
the surface-mesh writers and readers (STL, OBJ)."""

from evosoro_tpu_torch.io.mesh_io import (  # noqa: F401
    export_deformed_mesh,
    export_smooth_mesh,
    read_stl,
    write_obj,
    write_stl,
)
from evosoro_tpu_torch.io.vxa import load_vxa, read_fitness_xml, write_vxa  # noqa: F401
