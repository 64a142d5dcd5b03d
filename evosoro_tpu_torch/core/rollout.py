"""Rollouts over the eager step, and the trajectory statistics.

The port of `evosoro_tpu.core.rollout`: `init_state`, `center_of_mass`,
`num_steps_for`, and `rollout` with its `RolloutResult` fitness surface
(reference: VX_SimGA.cpp:25-203) on the port's envelope. Where the JAX
package `vmap`s `rollout`, this one takes leading batch dimensions on the
state and the controls, as `sim_step` does; fluid environments and development bodies run as the
step runs them. Sources, needle-in-haystack,
the fall-over latch, NormDistByVol, speed windows, ballistic devo and the
stop conditions other than max-sim-time are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from evosoro_tpu_torch.core import quaternion as q
from evosoro_tpu_torch.core.constants import DEFAULT_PRECISION, Precision
from evosoro_tpu_torch.core.materials import calc_max_dt
from evosoro_tpu_torch.core.step import freeze_where, sim_step
from evosoro_tpu_torch.core.types import EnvParams, SimParams, SimState, VoxelBody

_BIG = 1e5  # reference sentinel for "min over voxels" scans (VX_Sim.cpp:2603)


def init_state(body: VoxelBody, dtype=None, volume_effects: bool = False,
               ballistic_devo: bool = False) -> SimState:
    """Initial rest state of one robot (reference: VXS_Voxel.cpp:95-134
    ResetVoxel), on the body's device."""
    if volume_effects or ballistic_devo:
        raise NotImplementedError(
            "init_state: volume-effects and ballistic-devo carries are not "
            "ported yet")
    X, Y, Z = body.occ.shape[-3:]
    dtype = dtype or body.nom_pos.dtype
    dev = body.nom_pos.device
    nom = torch.full((X, Y, Z), body.nominal_size, dtype=dtype, device=dev)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return SimState(
        pos=body.nom_pos.to(dtype).clone(),
        quat=q.quat_identity((X, Y, Z), dtype=dtype, device=dev),
        linmom=z(X, Y, Z, 3),
        angmom=z(X, Y, Z, 3),
        scale=nom,
        last_scale=nom.clone(),
        small_angle=torch.ones((3, X, Y, Z), dtype=torch.bool, device=dev),
        last_pos2=z(3, X, Y, Z, 3),
        last_angle1=z(3, X, Y, Z, 3),
        last_angle2=z(3, X, Y, Z, 3),
        max_strain=z(3, X, Y, Z),
        strain_offset=z(3, X, Y, Z),
        time=z(),
        diverged=torch.zeros((), dtype=torch.bool, device=dev),
        # the reference clears energy histories to -1 sentinels
        # (VX_Sim.h:421 ClearHistories)
        ke_history=torch.full((6,), -1.0, dtype=dtype, device=dev),
        total_strain_e=z(),
        max_vox_vel=z(),
    )


def center_of_mass(state: SimState, body: VoxelBody):
    """Mass-weighted CoM (reference: VX_Sim.cpp:2415-2430 GetCM), of shape
    batch + (3,)."""
    total_mass = body.mass.flatten(-3).sum(-1)
    num = (state.pos * body.mass[..., None]).flatten(-4, -2).sum(-2)
    return num / torch.where(total_mass > 0, total_mass, 1.0)[..., None]


def num_steps_for(body: VoxelBody, sim: SimParams, dt=None) -> int:
    """Step count covering the sim's stop time, afterlife included."""
    if dt is None:
        dt = float(calc_max_dt(body, sim.volume_effects_enabled)) * float(
            sim.dt_frac)
    total = float(sim.stop_condition_value) + float(sim.afterlife_time)
    steps = int(math.ceil(total / float(dt)))
    if sim.volume_effects_enabled:
        steps = int(math.ceil(steps * 1.15))
    return steps


def total_volume(state: SimState, body: VoxelBody):
    """Σ (scale/L)³ over occupied voxels: the dimensionless robot volume of
    the reference's getTotalVolume() (VX_Sim.cpp:2573-2580)."""
    s = state.scale / body.nominal_size
    return torch.where(body.occ, s * s * s, 0.0).flatten(-3).sum(-1)


def floor_penetration(state: SimState, body: VoxelBody):
    """Per-voxel ground penetration 0.5·scale − z (reference:
    VXS_Voxel.cpp:700-706), masked to occupancy."""
    pen = 0.5 * state.scale - state.pos[..., 2]
    return torch.where(body.occ, pen, 0.0)


def _touch_counts(state: SimState, body: VoxelBody):
    """(num_touching, num_mat6_touching): reference VX_Sim.cpp:2432-2441
    GetNumTouchingFloor and :2698-2713 GetNumNonFeetTouchingFloor."""
    touching = floor_penetration(state, body) > 0
    n_all = (touching & body.occ).flatten(-3).sum(-1)
    n_feet = (touching & (body.mat == 6)).flatten(-3).sum(-1)
    return n_all, n_feet


def _posterior_y(state: SimState, body: VoxelBody):
    """Min voxel y over non-obstacle voxels, in lattice units."""
    valid = body.occ & (body.mat != 5)
    y = state.pos[..., 1] / body.nominal_size
    return torch.where(valid, y, _BIG).flatten(-3).amin(-1)


def _safe_norm2(x, y):
    """sqrt(x² + y²) with the JAX package's double `where` around the root."""
    dsq = x * x + y * y
    return torch.where(dsq > 0, torch.sqrt(torch.where(dsq > 0, dsq, 1.0)), 0.0)


@dataclasses.dataclass
class RolloutResult:
    """Outputs of one rollout, or of a batch of them: the counterpart of
    the reference fitness XML (VX_SimGA.cpp:140-203 WriteResultFile). The
    fields of features that are not ported keep their off-values."""

    final_state: SimState
    ini_cm: Any  # CoM captured when t first exceeds init_cm_time
    final_cm: Any
    norm_final_dist: Any
    final_dist: Any
    final_dist_y: Any
    norm_regime_dist: Any
    norm_frozen_dist: Any
    anterior_dist: Any
    posterior_dist: Any
    anterior_y: Any
    posterior_y: Any
    end_of_life_posterior_y: Any
    fall_adj_post_y: Any
    fell_over: Any
    num_touching_floor: Any
    num_non_feet_touching_floor: Any
    lifetime: Any
    found_needle: Any
    push_dist: Any
    norm_window_dist: Any
    diverged: Any
    cm_trace: Any  # (..., T_trace, 3) CoM snapshots, None without a trace
    vol_trace: Any  # (..., T_trace)
    trace_times: Any
    source_min_dist: Any = None
    source_avg_min_dist: Any = None


def _expand_state(state: SimState, batch_shape, init_batch) -> SimState:
    """`state` with its leading batch shape broadcast up to `batch_shape`."""
    if tuple(init_batch) == tuple(batch_shape):
        return state
    nb = len(init_batch)
    out = {}
    for f in dataclasses.fields(SimState):
        v = getattr(state, f.name)
        if torch.is_tensor(v):
            out[f.name] = v.expand(tuple(batch_shape) + tuple(v.shape[nb:]))
    return state.replace(**out)


def rollout(
    body: VoxelBody,
    sim: SimParams,
    env: EnvParams,
    num_steps: int,
    dt=None,
    state: SimState | None = None,
    prec: Precision = DEFAULT_PRECISION,
    trace_every: int = 0,
    control_sequence=None,
    stop_time=None,
    stop_condition_type: int | None = None,
) -> RolloutResult:
    """Run `num_steps` of the eager step and reduce the fitness statistics.

    `control_sequence`: optional (..., K, X, Y, Z) per-voxel scale
    modulation; knot k is active for steps [k*S/K, (k+1)*S/K), the MPC
    actuation channel. Its leading dimensions are the batch; a state
    without them is broadcast. `trace_every > 0` records the CoM, the robot
    volume and the time every that many steps. `stop_time`: optional
    per-rollout SC_MAX_SIM_TIME value (a float or a tensor of the batch
    shape); once a rollout's time passes it, its state freezes.
    """
    refused = [
        ("environmental sources", env.sources is not None),
        ("needle in haystack", env.needle_in_haystack),
        ("the fall-over latch", env.falling_prohibited),
        ("NormDistByVol", env.norm_dist_by_vol),
        ("speed windows", int(env.num_trace_steps_in_window) > 0),
        ("stop conditions other than max sim time",
         stop_condition_type is not None),
    ]
    for name, on in refused:
        if on:
            raise NotImplementedError(f"rollout: {name} is not ported yet")
    if dt is None:
        dt = calc_max_dt(body, sim.volume_effects_enabled) * sim.dt_frac
    if state is None:
        state = init_state(body, volume_effects=sim.volume_effects_enabled)
    if state.devo is not None:
        raise NotImplementedError("rollout: ballistic devo is not ported yet")

    batch = tuple(state.time.shape)
    n_knots = 0
    if control_sequence is not None:
        control_sequence = torch.as_tensor(
            control_sequence, dtype=state.pos.dtype, device=state.pos.device)
        if tuple(control_sequence.shape[-3:]) != tuple(body.occ.shape[-3:]) \
                or control_sequence.dim() < 4:
            raise ValueError("control_sequence must be (..., K, X, Y, Z), got "
                             f"{tuple(control_sequence.shape)}")
        n_knots = control_sequence.shape[-4]
        full = torch.broadcast_shapes(batch, tuple(control_sequence.shape[:-4]))
        state = _expand_state(state, full, batch)
        batch = tuple(full)
    nb = len(batch)
    dtype, dev = state.pos.dtype, state.pos.device
    if stop_time is not None:
        stop_time = torch.as_tensor(stop_time, dtype=dtype, device=dev)

    def false():
        return torch.zeros(batch, dtype=torch.bool, device=dev)

    ini_cm = center_of_mass(state, body)
    cm_initialized = false()
    eol_y = torch.zeros(batch, dtype=dtype, device=dev)
    eol_captured = false()
    stride = max(trace_every, 1)
    cms, vols, times = [], [], []

    for i in range(num_steps):
        # IniCM capture at the top of TimeStep once CurTime has passed
        # InitCmTime (reference: VX_Sim.cpp:1064-1075), from the previous
        # step's positions
        cm_now = center_of_mass(state, body)
        capture = ~cm_initialized & (state.time > sim.init_cm_time)
        ini_cm = torch.where(capture[..., None], cm_now, ini_cm)
        cm_initialized = cm_initialized | capture

        # end-of-lifetime posterior-Y capture (reference: VX_Sim.cpp:1078-1082)
        eol_cap = ~eol_captured & (state.time >= sim.stop_condition_value)
        eol_y = torch.where(eol_cap, _posterior_y(state, body), eol_y)
        eol_captured = eol_captured | eol_cap

        ctrl = None
        if n_knots:
            knot = min(i * n_knots // num_steps, n_knots - 1)
            ctrl = control_sequence[..., knot, :, :, :]

        if trace_every > 0 and i % stride == 0:
            cms.append(cm_now)
            vols.append(total_volume(state, body).expand(batch))
            times.append(state.time)

        new_state = sim_step(state, body, sim, env, dt, prec, control_offset=ctrl)
        if stop_time is not None:
            new_state = freeze_where(state.time >= stop_time, state, new_state)
        state = new_state

    cm_trace = vol_trace = trace_times = None
    if trace_every > 0:
        cm_trace = torch.stack(cms, dim=nb)
        vol_trace = torch.stack(vols, dim=nb)
        trace_times = torch.stack(times, dim=nb)

    final = state
    L = body.nominal_size
    final_cm = center_of_mass(final, body)
    delta = final_cm - ini_cm
    final_dist = _safe_norm2(delta[..., 0], delta[..., 1]) / L
    final_dist_y = delta[..., 1] / L

    # anterior/posterior voxel extremes (reference: VX_Sim.cpp:2584-2697)
    vdel = final.pos[..., :2] - ini_cm[..., None, None, None, :2]
    vdist = _safe_norm2(vdel[..., 0], vdel[..., 1]) / L
    anterior_dist = torch.where(body.occ, vdist, 0.0).flatten(-3).amax(-1)
    posterior_dist = torch.where(body.occ, vdist, _BIG).flatten(-3).amin(-1)
    # voxel y in lattice units, AnteriorY floored at 0 by its accumulator
    non_obstacle = body.occ & (body.mat != 5)
    y_l = final.pos[..., 1] / L
    anterior_y = torch.where(non_obstacle, y_l, 0.0).flatten(-3).amax(-1)
    posterior_y = torch.where(non_obstacle, y_l, _BIG).flatten(-3).amin(-1)

    n_all, n_feet = _touch_counts(final, body)

    zero = torch.zeros_like(final_dist)
    # the reference subtracts the raw-metres posterior Y from the
    # L-normalized posterior distance (VX_SimGA.cpp:39 normRegimeDist)
    norm_regime_dist = posterior_dist - eol_y
    # diverged rollouts score worst (evosoro: tools/evaluation.py:107-110)
    norm_final_dist = torch.where(final.diverged, 0.0, final_dist)

    return RolloutResult(
        final_state=final,
        ini_cm=ini_cm,
        final_cm=final_cm,
        norm_final_dist=norm_final_dist,
        final_dist=final_dist,
        final_dist_y=final_dist_y,
        norm_regime_dist=norm_regime_dist,
        norm_frozen_dist=zero,
        anterior_dist=anterior_dist,
        posterior_dist=posterior_dist,
        anterior_y=anterior_y,
        posterior_y=posterior_y,
        end_of_life_posterior_y=eol_y,
        fall_adj_post_y=eol_y,
        fell_over=false(),
        num_touching_floor=n_all,
        num_non_feet_touching_floor=n_feet,
        lifetime=final.time - sim.afterlife_time,
        found_needle=torch.zeros(batch, dtype=torch.int32, device=dev),
        push_dist=zero,
        norm_window_dist=zero,
        diverged=final.diverged,
        cm_trace=cm_trace,
        vol_trace=vol_trace,
        trace_times=trace_times,
    )
