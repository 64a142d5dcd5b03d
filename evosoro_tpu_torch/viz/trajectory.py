"""Trajectory recording: downsampled pose snapshots of a rollout.

The port of `evosoro_tpu.viz.trajectory`. The reference's visual check is
"run the .vxa in VoxCad and watch it" (reference: README.md:120-140); here
(pos, quat, scale, time) is recorded every `every` steps and the stacked
snapshots go to the renderer.

The JAX package scans its jnp step under one jit. The port's counterpart of
a compiled rollout is K1, so a trajectory inside K1's envelope runs K1: one
launch a frame, the packed state and the stats row (whose time drives the
actuation) carried from launch to launch, unpacked only for the snapshots.
The K1 launches run the physics of `sim_step`, which is all the JAX
package's scan runs: the fitness features' bookkeeping stays off (their
fall-over latch would freeze the robot, which `sim_step` never does). Outside
the envelope, and for a state that carries a DevoState (K1 rebases it only
under speed windows), the eager `sim_step` runs, one step at a time. The
route is decided once, before any step, and a K1 error raises.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from evosoro_tpu_torch.core.rollout import init_state
from evosoro_tpu_torch.core.step import sim_step
from evosoro_tpu_torch.core.types import EnvParams, SimParams, SimState, VoxelBody


class Trajectory(NamedTuple):
    """(F, ...) stacked pose snapshots of one rollout."""

    pos: Any  # (F, X, Y, Z, 3)
    quat: Any  # (F, X, Y, Z, 4)
    scale: Any  # (F, X, Y, Z)
    time: Any  # (F,)
    final_state: SimState


def _physics_env(env: EnvParams) -> EnvParams:
    """`env` without the fitness features, which `sim_step` does not run."""
    return env.replace(needle_in_haystack=False, falling_prohibited=False,
                       norm_dist_by_vol=False, num_trace_steps_in_window=0, sources=None)


def eager_reason(body: VoxelBody, sim: SimParams, env: EnvParams, state: SimState):
    """Why a trajectory of (body, sim, env) from `state` runs the eager step,
    or None when it runs K1."""
    from evosoro_tpu_torch.ops import fused_rollout as fr

    if state.devo is not None:
        return "the state carries a DevoState, which K1 rebases only under speed windows"
    return fr.refusal(body, sim, _physics_env(env))


class K1Chain:
    """One robot's K1 launches, each continuing the last: the packed state
    and stats row are carried over, and under a control sequence each
    launch runs in segmented mode from the steps already taken, so that
    chained launches give the bits of one launch over all their steps."""

    def __init__(self, body: VoxelBody, sim: SimParams, env: EnvParams, state: SimState,
                 dt, num_steps: int, control_sequence=None):
        from evosoro_tpu_torch.ops import fused_rollout as fr
        from evosoro_tpu_torch.parallel.mesh import tree_map

        self.body, self.sim, self.env = body, sim, _physics_env(env)
        self.start = tree_map(lambda t: t[None], state)
        ctrl = None
        if control_sequence is not None:
            ctrl = torch.as_tensor(control_sequence, device=state.pos.device)[None]
        self.segmented = ctrl is not None
        args, self.kw = fr.launch_inputs(self.start, body, sim, self.env, dt,
                                         control_sequence=ctrl,
                                         **({"segmented": True} if self.segmented else {}))
        self.state, self.body_packed, self.stats, self.collision = args
        if self.segmented:
            self.kw["total_steps"] = int(num_steps)
        self.done = 0

    def advance(self, steps: int):
        """One K1 launch of `steps` steps."""
        from evosoro_tpu_torch.ops import fused_rollout as fr

        seg = {"seg_base": self.done} if self.segmented else {}
        self.state, self.stats = fr.fused_call(
            self.state, self.body_packed, self.stats, self.collision,
            num_steps=int(steps), **seg, **self.kw)
        self.done += int(steps)
        return self

    def pose(self):
        """(pos, quat, scale, time) of the robot now, in the state's dtype."""
        from evosoro_tpu_torch.ops import fused_rollout as fr

        X, Y, Z = self.body.occ.shape
        dtype = self.start.pos.dtype

        def ch(lo, n):
            c = self.state[0, lo:lo + n].reshape(n, X, Y, Z).to(dtype)
            return c.movedim(0, -1)

        return (ch(fr._POS, 3), ch(fr._QUAT, 4), ch(fr._SCALE, 1)[..., 0],
                self.stats[0, fr._S_TIME].to(self.start.time.dtype))

    def final_state(self) -> SimState:
        """The unbatched SimState now. K1 carries the dynamic fields; the
        per-step bookkeeping it does not write (`total_strain_e`,
        `max_vox_vel`, and `ke_history` outside equilibrium mode) keeps the
        start state's values."""
        from evosoro_tpu_torch.ops import fused_rollout as fr
        from evosoro_tpu_torch.parallel.mesh import tree_map

        st, _ = fr.launch_outputs(self.state, self.stats, self.start, self.body,
                                  self.sim, self.env)
        return tree_map(lambda t: t[0], st)


def record_trajectory(
    body: VoxelBody,
    sim: SimParams,
    env: EnvParams,
    num_steps: int,
    dt=None,
    every: int = 50,
    state: SimState | None = None,
    control_sequence=None,
) -> Trajectory:
    """Run the physics and stack a pose snapshot every `every` steps
    (snapshot f is the state at the top of step f*every; the initial state
    is frame 0; the steps past the last frame run after it). Inside K1's
    envelope K1 runs it, else the eager step (module docstring).
    `control_sequence` (K, X, Y, Z): knot min(i*K // num_steps, K - 1)
    drives step i. Tensors stay on the body's device.

    On the K1 route two things differ from the eager route. On the card K1
    computes in float32 whatever the body's dtype, as `fused_rollout` does:
    a float64 body's frames come back as float64 tensors holding float32
    values (on the CPU, K1's plain version keeps float64). And the final
    state keeps the start state's `max_vox_vel` and `total_strain_e`, which
    K1 does not carry (`K1Chain.final_state`), where the eager step updates
    them."""
    from evosoro_tpu_torch.core.materials import calc_max_dt

    if dt is None:
        dt = calc_max_dt(body) * sim.dt_frac
    if state is None:
        state = init_state(body, volume_effects=sim.volume_effects_enabled)
    route = "eager" if eager_reason(body, sim, env, state) else "k1"
    return _record(body, sim, env, num_steps, dt, every, state, control_sequence, route)


def _record(body, sim, env, num_steps, dt, every, state, control_sequence,
            route) -> Trajectory:
    """`record_trajectory` on the route given ("k1" or "eager")."""
    n_frames = max(1, num_steps // every)
    rem = num_steps - n_frames * every
    frames = []
    if route == "k1":
        chain = K1Chain(body, sim, env, state, dt, num_steps, control_sequence)
        for _ in range(n_frames):
            frames.append(chain.pose())
            chain.advance(every)
        if rem > 0:
            chain.advance(rem)
        final = chain.final_state()
    else:
        n_knots = 0 if control_sequence is None else control_sequence.shape[0]
        if control_sequence is not None:
            control_sequence = torch.as_tensor(control_sequence, device=state.pos.device)

        def one_step(i, st):
            ctrl = None
            if n_knots:
                ctrl = control_sequence[min(i * n_knots // num_steps, n_knots - 1)]
            return sim_step(st, body, sim, env, dt, control_offset=ctrl)

        final = state
        for f in range(n_frames):
            frames.append((final.pos, final.quat, final.scale, final.time))
            for j in range(every):
                final = one_step(f * every + j, final)
        for j in range(rem):
            final = one_step(n_frames * every + j, final)
    pos, quat, scale, time = (torch.stack(list(c)) for c in zip(*frames))
    return Trajectory(pos=pos, quat=quat, scale=scale, time=time, final_state=final)
