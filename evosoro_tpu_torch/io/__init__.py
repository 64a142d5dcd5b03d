"""IO: the VXA (VoxCad XML) reader and writer for reference interop."""

from evosoro_tpu_torch.io.vxa import load_vxa, read_fitness_xml, write_vxa  # noqa: F401
