"""Environment presets.

The port of `evosoro_tpu.envs`: each preset is a constructor of `EnvParams`
(reference: examples/basic.py:134, growth.py:98-99,
swimming_basic.py:135-138). The boundary-condition region helpers are in
`regions.py`. The circular limited floor (`limited_floor`) is not ported
yet: the eager step refuses it.
"""

from __future__ import annotations

from evosoro_tpu_torch.core.types import EnvParams


def terrestrial(
    frequency: float = 4.0,
    temp_amp: float = 39.0,
    sticky_floor: bool = False,
    gravity: float = -9.81,
    lattice_dim: float = 0.01,
) -> EnvParams:
    """Flat-floor walking environment (reference: examples/basic.py:134;
    Env defaults base.py:50-74)."""
    return EnvParams(
        grav_acc=gravity,
        temp_amplitude=temp_amp,
        temp_period=1.0 / frequency,
        sticky_floor=sticky_floor,
        lattice_dim=lattice_dim,
    )


def growth_env(
    growth_amplitude: float = 0.8,
    frequency: float = 4.0,
    temp_amp: float = 39.0,
    lattice_dim: float = 0.01,
) -> EnvParams:
    """Developmental-growth environment (reference: examples/growth.py:98-99
    sets <GrowthAmplitude>)."""
    return EnvParams(
        temp_amplitude=temp_amp,
        temp_period=1.0 / frequency,
        growth_amplitude=growth_amplitude,
        lattice_dim=lattice_dim,
    )


def aquatic(
    aggregate_drag_coefficient: float = 0.5 * 1.5 * 1000.0,
    frequency: float = 4.0,
    temp_amp: float = 39.0,
    lattice_dim: float = 0.01,
) -> EnvParams:
    """Neutral-buoyancy fluid environment with quadratic facet drag
    (reference: examples/swimming_basic.py:137-138; land_water fork
    VX_Environment.cpp:190-191: fluid disables gravity and floor)."""
    return EnvParams(
        temp_amplitude=temp_amp,
        temp_period=1.0 / frequency,
        fluid_environment=True,
        gravity_enabled=False,
        floor_enabled=False,
        aggregate_drag_coefficient=aggregate_drag_coefficient,
        lattice_dim=lattice_dim,
    )
