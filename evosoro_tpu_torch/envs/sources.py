"""Environmental sources (light/heat beacons) and pointing-error metrics.

The port of `evosoro_tpu.envs.sources` (reference: VX_Source,
VX_Environment.h:40-130): each source has a base position, optional
per-axis sinusoidal motion, and tracks its minimum distance to the robot.
The engine moves the sources once actuation starts
(updateSourcesPosition(CurTime - InitCmTime), VX_Sim.cpp:1905-1907) and
recomputes nearest-voxel distances at the top of every step
(updateSourcesInformation, VX_Sim.cpp:2527-2558), pushing a history sample
every UPDATE_SOURCES_HIST_EVERY = 50 steps (VX_Sim.h:41) whose mean is the
average-minimum-distance statistic. Here the per-voxel scan is a masked
min-reduction over a batch of states.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from evosoro_tpu_torch.core.types import _Replace

# reference: Utils/Vec3D.h:21, the engine's PI literal (14 digits)
REF_PI_VEC3D = 3.14159265358979

# reference: VX_Sim.h:41-42
UPDATE_SOURCES_HIST_EVERY = 50
POINTING_ERROR_SAMPLING_STEPS = 25


@dataclasses.dataclass
class EnvSources(_Replace):
    """Array-of-sources parameters (reference VXA <Sources><Source> block,
    VX_Environment.cpp:241-285)."""

    base_pos: Any  # (S, 3) [m]
    amp: Any  # (S, 3) motion amplitude per axis [m]
    freq: Any  # (S, 3) motion frequency per axis [Hz]
    enabled: Any  # (S,) bool
    source_type: Any  # (S,) int32 (SourceType enum; 0 = light)

    @property
    def num_sources(self):
        return self.base_pos.shape[0]


def make_sources(entries, dtype=torch.float64) -> EnvSources | None:
    """EnvSources from dicts with keys name/type/enabled/pos/amp/freq."""
    if not entries:
        return None
    S = len(entries)
    base = np.zeros((S, 3))
    amp = np.zeros((S, 3))
    freq = np.zeros((S, 3))
    enabled = np.zeros((S,), bool)
    stype = np.zeros((S,), np.int32)
    for i, e in enumerate(entries):
        base[i] = e.get("pos", (0, 0, 0))
        amp[i] = e.get("amp", (0, 0, 0))
        freq[i] = e.get("freq", (0, 0, 0))
        enabled[i] = bool(e.get("enabled", False))
        stype[i] = int(e.get("type", 0))
    return EnvSources(
        base_pos=torch.as_tensor(base, dtype=dtype),
        amp=torch.as_tensor(amp, dtype=dtype),
        freq=torch.as_tensor(freq, dtype=dtype),
        enabled=torch.as_tensor(enabled),
        source_type=torch.as_tensor(stype),
    )


def source_positions(sources: EnvSources, tau):
    """Oscillating positions (..., S, 3) at time-since-actuation `tau` (a
    float or a tensor of a batch shape; reference: VX_Environment.h:110
    updateSourcePosition: base + amp·sin(2π·freq·t))."""
    tau = torch.as_tensor(tau, dtype=sources.base_pos.dtype)
    tau = tau.to(sources.base_pos.device)[..., None, None]
    return sources.base_pos + sources.amp * torch.sin(
        2.0 * REF_PI_VEC3D * sources.freq * tau)


def min_distances(positions, state, body):
    """Per-source minimum distance to any occupied voxel, in lattice units
    (reference: VX_Sim.cpp:2540-2549 divides by GetLatticeDim).
    positions (..., S, 3), state.pos (..., X, Y, Z, 3) -> (..., S)."""
    pos = state.pos.flatten(-4, -2)  # (..., V, 3)
    d = positions[..., :, None, :].to(pos.device) - pos[..., None, :, :]
    dist2 = (d * d).sum(-1)  # (..., S, V)
    occ = body.occ.flatten(-3)[..., None, :]
    dist2 = torch.where(occ, dist2, torch.inf)
    return torch.sqrt(dist2.amin(-1)) / body.nominal_size


def pointing_error_deg(tip_pos, tip_quat, initial_pointing_vector, target_pos):
    """Signed planar pointing error in degrees (reference:
    VX_Sim.cpp:1010-1046 computePointingError). The sign uses N = +X as the
    plane normal ("WORKS ONLY IN THE PLANAR CASE" per the reference)."""
    from evosoro_tpu_torch.core import quaternion as q

    a = q.quat_rotate(tip_quat, torch.as_tensor(initial_pointing_vector,
                                                dtype=tip_quat.dtype))
    b = torch.as_tensor(target_pos, dtype=a.dtype) - tip_pos
    na = a / torch.linalg.norm(a)
    nb = b / torch.linalg.norm(b)
    cosang = torch.clamp((na * nb).sum(), -1.0, 1.0)
    err = torch.rad2deg(torch.arccos(cosang))
    cross = torch.linalg.cross(nb, na)
    return torch.where(cross[0] < 0, -err, err)
