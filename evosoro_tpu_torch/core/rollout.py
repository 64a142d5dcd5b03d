"""Rollouts over the eager step, and the trajectory statistics.

The port of `evosoro_tpu.core.rollout`: `init_state`, `center_of_mass`,
`num_steps_for`, and `rollout` with its `RolloutResult` fitness surface
(reference: VX_SimGA.cpp:25-203) on the port's envelope. Where the JAX
package `vmap`s `rollout`, this one takes leading batch dimensions on the
state and the controls, as `sim_step` does; fluid environments and development bodies run as the
step runs them. The fitness features run as in the JAX package:
environmental sources, needle-in-haystack, the fall-over latch,
NormDistByVol over the CoM/volume trace, the trailing window distance and
the speed windows of ballistic development, and the reference's stop
conditions (`stop_condition_type`, VX_Sim.cpp:1398-1510), as the JAX
package's eager rollout runs them. Under volume effects each step advances
the time by the dt it recomputed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from evosoro_tpu_torch.core import quaternion as q
from evosoro_tpu_torch.core import types as _types
from evosoro_tpu_torch.core.constants import DEFAULT_PRECISION, Precision
from evosoro_tpu_torch.core.materials import calc_max_dt
from evosoro_tpu_torch.core.step import freeze_where, sim_step
from evosoro_tpu_torch.core.types import DevoState, EnvParams, SimParams, SimState, VoxelBody

_BIG = 1e5  # reference sentinel for "min over voxels" scans (VX_Sim.cpp:2603)


def init_state(body: VoxelBody, dtype=None, volume_effects: bool = False,
               ballistic_devo: bool = False) -> SimState:
    """Initial rest state of one robot, or of a batch of them when the body
    is a stack of designs (its leading dimensions) (reference:
    VXS_Voxel.cpp:95-134 ResetVoxel), on the body's device.

    `volume_effects`: carry the Poisson coupling's per-side transverse
    strain sums (zeros) and cross-sections (L²) (reference:
    VXS_Voxel.cpp:543-632) and the per-step dt (0: the first bond pass
    takes the caller's dt; VX_Sim.cpp:1792-1794).

    `ballistic_devo`: carry the dynamic DevoState, so that velocity-adjusted
    development can rebase the per-voxel development fields every step
    (reference: VXS_Voxel.cpp:342-381; see types.DevoState)."""
    X, Y, Z = body.occ.shape[-3:]
    b = tuple(body.occ.shape[:-3])
    grid = b + (X, Y, Z)
    dtype = dtype or body.nom_pos.dtype
    dev = body.nom_pos.device
    nom = torch.full(grid, body.nominal_size, dtype=dtype, device=dev)

    def z(*shape):
        return torch.zeros(b + shape, dtype=dtype, device=dev)

    vol = {}
    if volume_effects:
        L2 = body.nominal_size * body.nominal_size
        vol = dict(ts_sum=z(2, 3, X, Y, Z),
                   cs_area=torch.full(b + (2, 3, X, Y, Z), L2, dtype=dtype, device=dev),
                   cur_dt=z())
    devo = None
    if ballistic_devo:
        def f(a):
            return torch.as_tensor(a, device=dev).to(dtype).expand(grid).clone()

        devo = DevoState(
            initial_voxel_size=f(body.initial_voxel_size),
            final_voxel_size=f(body.final_voxel_size),
            original_final_voxel_size=f(body.final_voxel_size),
            growth_time=f(body.growth_time),
            start_growth_time=f(body.start_growth_time),
            win_prev=z(), win_last=z(),
            win_count=torch.zeros(b, dtype=torch.int32, device=dev),
        )
    return SimState(
        **vol,
        devo=devo,
        pos=body.nom_pos.to(dtype).clone(),
        quat=q.quat_identity(grid, dtype=dtype, device=dev),
        linmom=z(X, Y, Z, 3),
        angmom=z(X, Y, Z, 3),
        scale=nom,
        last_scale=nom.clone(),
        small_angle=torch.ones(b + (3, X, Y, Z), dtype=torch.bool, device=dev),
        last_pos2=z(3, X, Y, Z, 3),
        last_angle1=z(3, X, Y, Z, 3),
        last_angle2=z(3, X, Y, Z, 3),
        max_strain=z(3, X, Y, Z),
        strain_offset=z(3, X, Y, Z),
        time=z(),
        diverged=torch.zeros(b, dtype=torch.bool, device=dev),
        # the reference clears energy histories to -1 sentinels
        # (VX_Sim.h:421 ClearHistories)
        ke_history=torch.full(b + (6,), -1.0, dtype=dtype, device=dev),
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


def relaunch_until_stop(run, num_steps: int, short, on_relaunch=None):
    """Under volume effects the dt the step recomputes can shrink past the
    15 % pad of `num_steps_for`: `run(num_steps)`, and while `short(result)`
    (a bool array, one entry a rollout) holds anywhere, run again from the
    start 1.5 times as long, at most twice (the JAX package's evaluator; the
    reference loops until its stop condition, VX_Sim.cpp main loop).
    `on_relaunch(n_short, num_steps)` is called before each relaunch.
    Returns (result, num_steps, relaunches, still_short), the last the
    mask of the rollouts still short after the last launch."""
    result = run(num_steps)
    relaunches = 0
    still_short = short(result)
    while still_short.any() and relaunches < 2:
        num_steps = int(math.ceil(num_steps * 1.5))
        if on_relaunch is not None:
            on_relaunch(int(still_short.sum()), num_steps)
        result = run(num_steps)
        relaunches += 1
        still_short = short(result)
    return result, num_steps, relaunches, still_short


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


def _needle_pos(state: SimState, body: VoxelBody):
    """Position (..., 3) of the material-7 "needle" voxel (reference:
    VX_Sim.cpp:2715-2727 GetNeedlePosition; designs carry at most one, so a
    masked mean is exact); zeros without one."""
    is_needle = (body.mat == 7)[..., None]
    n = (body.mat == 7).flatten(-3).sum(-1).clamp(min=1)
    num = torch.where(is_needle, state.pos, 0.0).flatten(-4, -2).sum(-2)
    return num / n[..., None]


def _norm_dist_by_vol(cm_y, vols, mask, L, exponent):
    """Σ Δy/L / ((V_i + V_{i-1})/2)^exp over the trace intervals (last axis)
    whose two ends are in `mask` (reference: VX_SimGA.cpp:58-117; the
    reference keeps separate per-regime trace lists, so intervals that cross
    a regime boundary are left out here, as in the JAX package)."""
    dy = (cm_y[..., 1:] - cm_y[..., :-1]) / L
    avg_v = 0.5 * (vols[..., 1:] + vols[..., :-1])
    m = mask[..., 1:] & mask[..., :-1]
    safe_v = torch.where(avg_v > 0, avg_v, 1.0)
    return torch.where(m, dy / safe_v ** exponent, 0.0).sum(-1)


def _safe_norm2(x, y):
    """sqrt(x² + y²) with the JAX package's double `where` around the root."""
    dsq = x * x + y * y
    return torch.where(dsq > 0, torch.sqrt(torch.where(dsq > 0, dsq, 1.0)), 0.0)


@dataclasses.dataclass
class RolloutResult:
    """Outputs of one rollout, or of a batch of them: the counterpart of
    the reference fitness XML (VX_SimGA.cpp:140-203 WriteResultFile). The
    fields of features that are off keep their off-values."""

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

    def expand(v):
        return v.expand(tuple(batch_shape) + tuple(v.shape[nb:]))

    out = {f.name: expand(getattr(state, f.name)) for f in dataclasses.fields(SimState)
           if torch.is_tensor(getattr(state, f.name))}
    if state.devo is not None:
        out["devo"] = state.devo.replace(**{f.name: expand(getattr(state.devo, f.name))
                                            for f in dataclasses.fields(DevoState)})
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
    volume and the time every that many steps; NormDistByVol records them
    every step when `trace_every` is 0. `stop_time`: optional per-rollout
    SC_MAX_SIM_TIME value (a float or a tensor of the batch shape); once a
    rollout's time passes it, its state freezes, as it does once the
    fall-over latch trips. A state that carries a DevoState runs ballistic
    development under the environment's speed windows.

    `stop_condition_type`: one of types.SC_* (reference: VX_Enums.h:55-65,
    StopConditionMet VX_Sim.cpp:1398-1510). The loop always runs its
    `num_steps`; a met stop condition freezes the rollout's state (time
    included, so Lifetime reports the stop time). The quiescence conditions
    (SC_CONST_MAXENERGY, SC_MIN_KE, SC_MIN_MAXMOVE*) keep the reference's
    HISTORY_SIZE-deep check sampled every HISTORY_SIZE / 10 steps, the ring
    anchored at multiples of that step count rather than sliding every step;
    SC_POINTING_ERR keeps its max-sim-time part (the pointing error needs
    tip-voxel wiring the reference's command line never sets up), as in the
    JAX package. None is SC_MAX_SIM_TIME through `stop_time` / `num_steps`.
    """
    if stop_condition_type is not None and stop_condition_type not in range(
            _types.SC_NONE, _types.SC_POINTING_ERR + 1):
        raise ValueError(f"rollout: unknown stop_condition_type {stop_condition_type}")
    n_win = int(env.num_trace_steps_in_window)
    if dt is None:
        dt = calc_max_dt(body, sim.volume_effects_enabled) * sim.dt_frac
    if state is None:
        state = init_state(body, volume_effects=sim.volume_effects_enabled,
                           ballistic_devo=n_win > 0 and body.using_final_voxel_size)

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
    want_trace = trace_every > 0 or env.norm_dist_by_vol
    # ballistic development runs when the state carries a DevoState and the
    # environment defines speed windows (reference: NumTimeStepsInWindow > 0)
    ballistic = state.devo is not None and n_win > 0
    tb = env.time_between_traces
    nexp = env.normalization_exponent

    def false():
        return torch.zeros(batch, dtype=torch.bool, device=dev)

    def filled(shape, v, dt_=dtype):
        return torch.full(batch + shape, v, dtype=dt_, device=dev)

    ini_cm = center_of_mass(state, body)
    cm_initialized = false()
    eol_y = filled((), 0.0)
    eol_captured = false()
    fell = false()
    ini_needle = _needle_pos(state, body).expand(batch + (3,))
    needle_init = false()
    if ballistic:
        # windowed speed traces (reference: VX_Sim.cpp:1600-1606 WindowTrace)
        buf_y, buf_v = filled((n_win,), 0.0), filled((n_win,), 0.0)
        n_traces = filled((), 0, torch.int32)
        last_trace_t, last_win_t = filled((), -1.0), filled((), -1.0)
    if env.sources is not None:
        from evosoro_tpu_torch.envs.sources import (
            UPDATE_SOURCES_HIST_EVERY,
            min_distances,
            source_positions,
        )

        n_src = env.sources.num_sources
        src_min, src_sum = filled((n_src,), -1.0), filled((n_src,), 0.0)
        src_count = filled((), 0, torch.int32)
    stride = max(trace_every, 1)
    cms, vols, times = [], [], []
    sc = stop_condition_type
    history_scs = (_types.SC_CONST_MAXENERGY, _types.SC_MIN_KE, _types.SC_MIN_MAXMOVE,
                   _types.SC_MIN_MAXMOVE_MAX_SIM_TIME)
    if sc in history_scs:
        # downsampled history rings (reference: VX_Sim.cpp:1685-1687)
        num_jump = _types.HISTORY_SIZE // 10
        ring_ke, ring_tote, ring_move = (filled((10,), -1.0) for _ in range(3))
        n_vox_inv = 1.0 / torch.clamp(body.occ.flatten(-3).sum(-1), min=1).to(dtype)

    for i in range(num_steps):
        # environmental sources: distances at the top of the step from the
        # previous step's positions (reference: VX_Sim.cpp:1060
        # updateSourcesInformation runs before Integrate), with a history
        # sample every UPDATE_SOURCES_HIST_EVERY steps
        if env.sources is not None:
            tau = torch.clamp(state.time - sim.init_cm_time, min=0.0)
            src_min = min_distances(source_positions(env.sources, tau), state,
                                    body).to(dtype)
            if i % UPDATE_SOURCES_HIST_EVERY == 0:
                src_sum = src_sum + src_min
                src_count = src_count + 1
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

        # needle initial position (reference: VX_Sim.cpp:1084-1088)
        if env.needle_in_haystack:
            ncap = ~needle_init & (state.time > sim.init_cm_time)
            ini_needle = torch.where(ncap[..., None], _needle_pos(state, body), ini_needle)
            needle_init = needle_init | ncap

        # fall-over latch: more material-6 feet than non-feet touching the
        # floor ends the sim (reference: VX_Sim.cpp:1412-1419)
        if env.falling_prohibited:
            n_all, n_feet = _touch_counts(state, body)
            fell = fell | ((state.time > sim.init_cm_time) & (n_feet > n_all - n_feet))

        ctrl = None
        if n_knots:
            knot = min(i * n_knots // num_steps, n_knots - 1)
            ctrl = control_sequence[..., knot, :, :, :]

        if want_trace and i % stride == 0:
            cms.append(cm_now)
            vols.append(total_volume(state, body).expand(batch))
            times.append(state.time)

        new_state = sim_step(state, body, sim, env, dt, prec, control_offset=ctrl)

        # windowed speed traces for ballistic development: a window every
        # NumTimeStepsInWindow trace intervals once past InitCmTime
        # (reference: UpdateStats, VX_Sim.cpp:1600-1606)
        if ballistic:
            t_new = new_state.time
            trace_due = (t_new > sim.init_cm_time) & (
                (n_traces == 0) | (last_trace_t + tb <= t_new))
            cm_new = center_of_mass(new_state, body)
            vol_new = total_volume(new_state, body).expand(batch)
            due = trace_due[..., None]
            buf_y = torch.where(due, torch.cat([buf_y[..., 1:], cm_new[..., 1:2]], -1), buf_y)
            buf_v = torch.where(due, torch.cat([buf_v[..., 1:], vol_new[..., None]], -1), buf_v)
            n_traces = n_traces + trace_due.to(torch.int32)
            last_trace_t = torch.where(trace_due, t_new, last_trace_t)

            win_due = (t_new > sim.init_cm_time) & (
                (last_win_t < 0) | (last_win_t + n_win * tb <= t_new))
            dy = (buf_y[..., 1:] - buf_y[..., :-1]) / body.nominal_size
            avg_v = 0.5 * (buf_v[..., 1:] + buf_v[..., :-1])
            pair_ok = torch.arange(n_win - 1, device=dev) >= (
                n_win - torch.clamp(n_traces, max=n_win))[..., None]
            safe_v = torch.where(avg_v > 0, avg_v, 1.0)
            wdist = torch.where(pair_ok, dy / safe_v ** nexp, 0.0).sum(-1)
            devo = new_state.devo
            new_state = new_state.replace(devo=devo.replace(
                win_prev=torch.where(win_due, devo.win_last, devo.win_prev),
                win_last=torch.where(win_due, wdist, devo.win_last),
                win_count=devo.win_count + win_due.to(torch.int32)))
            last_win_t = torch.where(win_due, t_new, last_win_t)

        if env.falling_prohibited or stop_time is not None or sc is not None:
            stopped = fell
            if stop_time is not None:
                stopped = stopped | (state.time >= stop_time)
            if sc is not None:
                # stop conditions beyond max sim time, checked before each
                # step and gated on CurTime > InitCmTime (reference:
                # VX_Sim.cpp:1398-1510 StopConditionMet)
                met = false()
                scv = sim.stop_condition_value
                if sc == _types.SC_MAX_TIME_STEPS:
                    met = met | (i > int(float(scv) + 0.5))
                elif sc == _types.SC_TEMP_CYCLES:
                    met = state.time > env.temp_period * scv
                elif sc == _types.SC_POINTING_ERR:
                    met = state.time > scv
                elif sc in history_scs:
                    cur_ke = state.ke_history[..., 0]
                    cur_tote = cur_ke + state.total_strain_e
                    cur_move = state.max_vox_vel * dt
                    if sc == _types.SC_MIN_KE:
                        ok = (ring_ke >= 0) & (ring_ke * n_vox_inv[..., None] <= 0.001 * scv)
                        met = ok.all(-1) & (cur_ke * n_vox_inv <= 0.001 * scv)
                    elif sc == _types.SC_CONST_MAXENERGY:
                        ok = (ring_tote >= 0) & ((ring_tote - cur_tote[..., None]).abs()
                                                 * n_vox_inv[..., None] <= 0.001 * scv)
                        met = ok.all(-1)
                    elif sc == _types.SC_MIN_MAXMOVE:
                        ok = (ring_move >= 0) & (ring_move <= 0.001 * scv)
                        met = ok.all(-1) & (cur_move <= 0.001 * scv)
                    else:  # SC_MIN_MAXMOVE_MAX_SIM_TIME
                        thr = _types.MOTION_FLOOR_THR
                        ok = (ring_move >= 0) & (ring_move <= thr)
                        met = (state.time > scv) | (ok.all(-1) & (cur_move <= thr))
                    if i % num_jump == 0:  # push the history rings
                        def push(ring, cur):
                            return torch.cat([cur.expand(batch)[..., None], ring[..., :-1]], -1)

                        ring_ke = push(ring_ke, cur_ke)
                        ring_tote = push(ring_tote, cur_tote)
                        ring_move = push(ring_move, cur_move)
                stopped = stopped | ((state.time > sim.init_cm_time) & met)
            new_state = freeze_where(stopped, state, new_state)
        state = new_state

    cm_trace = vol_trace = trace_times = None
    if want_trace:
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

    # volume-normalized distances over the trace (reference:
    # VX_SimGA.cpp:58-117); plain |ΔCoM| when NormDistByVol is off
    zero = torch.zeros_like(final_dist)
    norm_final_dist = final_dist
    norm_frozen_dist = zero
    # the reference subtracts the raw-metres posterior Y from the
    # L-normalized posterior distance (VX_SimGA.cpp:39 normRegimeDist)
    norm_regime_dist = posterior_dist - eol_y
    if env.norm_dist_by_vol:
        cm_y = cm_trace[..., 1]
        every = torch.ones_like(trace_times, dtype=torch.bool)
        norm_final_dist = _norm_dist_by_vol(cm_y, vol_trace, every, L, nexp)
        regime = trace_times > sim.stop_condition_value
        norm_regime_dist = _norm_dist_by_vol(cm_y, vol_trace, regime, L, nexp)
        # frozen window mask (reference: VX_Sim.cpp:1090-1104)
        middle = 0.5 * (sim.stop_condition_value - sim.init_cm_time)
        fs = middle - 0.5 * sim.mid_life_freeze_time + sim.init_cm_time
        fe = middle + 0.5 * sim.mid_life_freeze_time
        frozen = (trace_times > fs) & (trace_times < fe)
        norm_frozen_dist = _norm_dist_by_vol(cm_y, vol_trace, frozen, L, nexp)

    # fixed trailing window distance (reference: VX_Sim.cpp:2745-2784)
    norm_window_dist = zero
    if n_win > 0 and want_trace:
        w = min(n_win, int(cm_trace.shape[nb]))
        norm_window_dist = _norm_dist_by_vol(
            cm_trace[..., -w:, 1], vol_trace[..., -w:],
            torch.ones(w, dtype=torch.bool, device=dev), L, nexp)

    # needle-in-haystack (reference: VX_SimGA.cpp:45-55)
    push_dist = zero
    found_needle = torch.zeros(batch, dtype=torch.int32, device=dev)
    if env.needle_in_haystack:
        nd = _needle_pos(final, body)[..., :2] - ini_needle[..., :2]
        push_dist = _safe_norm2(nd[..., 0], nd[..., 1]) / L
        found_needle = ((nd[..., 0] ** 2 + nd[..., 1] ** 2) > 0).to(torch.int32)

    # fall-over zeroing (reference: VX_SimGA.cpp:115-126; the penalty
    # subtracts the workspace Z dimension in voxel counts, GetVZDim)
    fall_adj_post_y = eol_y
    if env.falling_prohibited:
        Z = body.occ.shape[-1]
        fall_adj_post_y = torch.where(fell, eol_y - Z, eol_y)
        norm_final_dist = torch.where(fell, 0.0, norm_final_dist)
        norm_regime_dist = torch.where(fell, 0.0, norm_regime_dist)
        norm_frozen_dist = torch.where(fell, 0.0, norm_frozen_dist)

    # the reported headline fitness subtracts the frozen-window distance
    # (reference: VX_SimGA.cpp:145 "NormFinalDist" element)
    norm_final_dist = norm_final_dist - norm_frozen_dist
    # diverged rollouts score worst (evosoro: tools/evaluation.py:107-110)
    norm_final_dist = torch.where(final.diverged, 0.0, norm_final_dist)

    source_min_dist = source_avg_min_dist = None
    if env.sources is not None:
        source_min_dist = src_min
        source_avg_min_dist = torch.where(
            src_count[..., None] > 0,
            src_sum / torch.clamp(src_count, min=1)[..., None], -1.0)

    return RolloutResult(
        final_state=final,
        ini_cm=ini_cm,
        final_cm=final_cm,
        norm_final_dist=norm_final_dist,
        final_dist=final_dist,
        final_dist_y=final_dist_y,
        norm_regime_dist=norm_regime_dist,
        norm_frozen_dist=norm_frozen_dist,
        anterior_dist=anterior_dist,
        posterior_dist=posterior_dist,
        anterior_y=anterior_y,
        posterior_y=posterior_y,
        end_of_life_posterior_y=eol_y,
        fall_adj_post_y=fall_adj_post_y,
        fell_over=fell,
        num_touching_floor=n_all,
        num_non_feet_touching_floor=n_feet,
        lifetime=final.time - sim.afterlife_time,
        found_needle=found_needle,
        push_dist=push_dist,
        norm_window_dist=norm_window_dist,
        diverged=final.diverged,
        cm_trace=cm_trace,
        vol_trace=vol_trace,
        trace_times=trace_times,
        source_min_dist=source_min_dist,
        source_avg_min_dist=source_avg_min_dist,
    )
