"""Boundary-condition regions, the VX_FRegion analog (the port of
`evosoro_tpu.envs.regions`, host-only numpy).

The reference defines fixed/forced regions as geometric primitives in
normalized workspace coordinates with DOF bitmasks and force vectors
(reference: VX_FRegion.h:32-42 DOF helpers, VX_FRegion.cpp primitives;
applied to voxels at import: VX_Sim.cpp:488-722). Here a region is a pure
predicate over normalized voxel centers; `fixed_region_arrays` /
`forced_region_arrays` bake region lists into the dense per-voxel
`dof_fixed` / `external_force` arrays that `build_body` consumes — the
hot loop never evaluates geometry.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from evosoro_tpu_torch.core.types import DOF_ALL


@dataclasses.dataclass(frozen=True)
class Region:
    """A geometric predicate over normalized [0,1]³ workspace coords."""

    contains: Callable[[np.ndarray], np.ndarray]  # (N,3) -> (N,) bool
    dof: int = DOF_ALL
    force: tuple = (0.0, 0.0, 0.0)  # total force, split equally over voxels
    displacement: tuple = (0.0, 0.0, 0.0)


def box_region(x=(0.0, 1.0), y=(0.0, 1.0), z=(0.0, 1.0), dof=DOF_ALL,
               force=(0.0, 0.0, 0.0), displacement=(0.0, 0.0, 0.0)) -> Region:
    """Axis-aligned box in normalized coords (reference:
    VX_FRegion CreateBoxRegion)."""

    def contains(p):
        return (
            (p[:, 0] >= x[0]) & (p[:, 0] <= x[1])
            & (p[:, 1] >= y[0]) & (p[:, 1] <= y[1])
            & (p[:, 2] >= z[0]) & (p[:, 2] <= z[1])
        )

    return Region(contains, dof, force, displacement)


def cylinder_region(axis=2, center=(0.5, 0.5), radius=0.5, span=(0.0, 1.0),
                    dof=DOF_ALL, force=(0.0, 0.0, 0.0)) -> Region:
    """Axis-aligned cylinder (reference: VX_FRegion cylinder primitive)."""
    lat = [i for i in range(3) if i != axis]

    def contains(p):
        r = np.sqrt(
            (p[:, lat[0]] - center[0]) ** 2 + (p[:, lat[1]] - center[1]) ** 2
        )
        return (r <= radius) & (p[:, axis] >= span[0]) & (p[:, axis] <= span[1])

    return Region(contains, dof, force)


def sphere_region(center=(0.5, 0.5, 0.5), radius=0.5, dof=DOF_ALL,
                  force=(0.0, 0.0, 0.0)) -> Region:
    """Sphere primitive (reference: VX_FRegion sphere primitive)."""
    c = np.asarray(center)

    def contains(p):
        return np.sqrt(np.sum((p - c) ** 2, axis=1)) <= radius

    return Region(contains, dof, force)


def _norm_coords(structure: np.ndarray) -> np.ndarray:
    """Normalized voxel-center coordinates of every lattice cell, matching
    the reference's workspace normalization (VX_FRegion uses [0,1] over the
    workspace; voxel centers at (i+0.5)/dim)."""
    X, Y, Z = structure.shape
    ix, iy, iz = np.meshgrid(
        np.arange(X), np.arange(Y), np.arange(Z), indexing="ij"
    )
    p = np.stack(
        [(ix + 0.5) / X, (iy + 0.5) / Y, (iz + 0.5) / Z], axis=-1
    ).reshape(-1, 3)
    return p


def fixed_region_arrays(structure: np.ndarray, regions: Sequence[Region]):
    """(X,Y,Z) int32 dof_fixed bitmask from fixed-BC regions
    (reference: VX_Environment.cpp:302-316 AddFixedBc + import application)."""
    structure = np.asarray(structure)
    p = _norm_coords(structure)
    dof = np.zeros(structure.size, dtype=np.int32)
    occ = (structure > 0).reshape(-1)
    for r in regions:
        inside = r.contains(p) & occ
        dof[inside] |= r.dof
    return dof.reshape(structure.shape)


def forced_region_arrays(structure: np.ndarray, regions: Sequence[Region]):
    """(X,Y,Z,3) external force from forced-BC regions. The reference splits
    the region's total force equally across the voxels it touches
    (VX_Sim.cpp import: Force/NumTouching)."""
    structure = np.asarray(structure)
    p = _norm_coords(structure)
    occ = (structure > 0).reshape(-1)
    force = np.zeros((structure.size, 3))
    for r in regions:
        inside = r.contains(p) & occ
        n = int(inside.sum())
        if n:
            force[inside] += np.asarray(r.force) / n
    return force.reshape(structure.shape + (3,))
