"""SQP-style shooting: Gauss-Newton / Levenberg-Marquardt trajectory
optimization over the rollout actuation channel.

The port of `evosoro_tpu/control/sqp.py`. The decision variable is the
control-knot sequence `u` of shape (K, X, Y, Z) the CEM optimizer uses
(`control.shooting`): per-voxel scale modulation, the thermal-actuation term
of VXS_Voxel.cpp:292-305 but free-form in time.

Formulation: nonlinear least squares over a tracked CoM trajectory

    r(u) = [ w_track * (dcm_y(t_i) - target_i)  for trace points t_i,
             w_reg * u ]

minimized by damped Gauss-Newton with a box constraint on u handled by
projection (clip) after each step. Two solvers:

- `sqp_optimize`: the eager path. Each iteration solves the regularized
  normal equations (J'J + lambda I) delta = -J'r with matrix-free conjugate
  gradients: every Jv is one forward-mode product through the eager rollout
  (`torch.func.jvp`) and every J'v one reverse-mode product (torch
  autograd), so the Jacobian is never materialized.
- `FusedSQPSolver`: the production path through the fused kernels. The
  rollout batch is `n_res` copies of the trajectory in `n_res` segments
  (`ops.fused_diff.DiffRollout`), and ONE backward pass with an identity
  cotangent block returns the whole tracking Jacobian: batch row i pulls
  back the CoM at boundary i. With J explicit and n_res small, the damped
  normal equations are solved exactly by the Woodbury identity through an
  (n_res, n_res) system. A solve is (2 num_iters + 1) n_res launches of the
  forward kernel K1 and num_iters n_res launches of the reverse-mode
  kernel B4, enqueued without waiting for the device: accept/reject and
  the LM damping are device-side selections.

The fused solver's envelope is `ops.fused_rollout.diff_envelope_ok`: on
land, in water and with growth, each also with bilinear materials and the
max-velocity clamp; a body or option outside it raises by name.
Entry points run on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses

import torch

from evosoro_tpu_torch.core.rollout import init_state, rollout
from evosoro_tpu_torch.core.types import EnvParams, SimParams, SimState, VoxelBody
from evosoro_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SQPConfig:
    num_iters: int = 6  # SQP (outer) iterations
    cg_iters: int = 8  # CG iterations per subproblem
    lm_lambda0: float = 1e-2  # initial LM damping
    lm_up: float = 4.0  # damping growth on rejected steps
    lm_down: float = 0.5  # damping decay on accepted steps
    w_track: float = 1.0
    w_reg: float = 3e-2
    u_clip: float = 0.2  # actuation box constraint (fraction of voxel size)
    n_res: int = 16  # number of CoM trace residual points


def _target_profile(target, n, dtype, device):
    """A scalar target (total displacement) becomes a linear ramp over the
    `n` trace points; an (n,) profile is taken as it is."""
    tgt = torch.as_tensor(target, dtype=dtype, device=device)
    if tgt.dim() == 0:
        tgt = tgt * torch.arange(1, n + 1, dtype=dtype, device=device) / n
    return tgt


def _tracking_residual(u, body, sim, env, num_steps, dt, state0, target,
                       config: SQPConfig):
    """r(u): CoM-y displacement at the trace points against the `target`
    profile, plus control regularization. Differentiable end to end through
    the eager rollout, in reverse and in forward mode."""
    trace_every = max(1, num_steps // config.n_res)
    res = rollout(body, sim, env, num_steps=num_steps, dt=dt, state=state0,
                  control_sequence=u, trace_every=trace_every)
    cm_y = res.cm_trace[:, 1]
    d_cm = (cm_y - cm_y[0]) / body.nominal_size
    tgt = _target_profile(target, d_cm.shape[0], d_cm.dtype, d_cm.device)
    r_track = config.w_track * (d_cm - tgt)
    r_reg = config.w_reg * u.reshape(-1)
    return torch.cat([r_track, r_reg])


def _cg(matvec, b, iters):
    """Plain conjugate gradients on an SPD `matvec`, a fixed number of
    iterations (small), guarded against a zero curvature or residual."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.vdot(r, r)
    for _ in range(iters):
        ap = matvec(p)
        denom = torch.vdot(p, ap)
        alpha = torch.where(denom > 0, rs / torch.where(denom > 0, denom, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.vdot(r, r)
        beta = torch.where(rs > 0, rs_new / torch.where(rs > 0, rs, 1.0), 0.0)
        p = r + beta * p
        rs = rs_new
    return x


def _lm_update(accept, lam, config: SQPConfig):
    return torch.where(accept, lam * config.lm_down, lam * config.lm_up)


def sqp_optimize(
    body: VoxelBody,
    sim: SimParams,
    env: EnvParams,
    num_steps: int,
    num_knots: int,
    target=0.5,
    config: SQPConfig = SQPConfig(),
    state0: SimState | None = None,
    dt=None,
    init_u=None,
    device=None,
):
    """Projected Gauss-Newton/LM shooting through the eager rollout.
    Returns (u, info).

    `target`: desired CoM-y displacement profile in lattice units: a scalar
    (total displacement, tracked as a linear ramp) or an array over the
    trace points.
    """
    device = resolve_device(device)
    body = body.to(device)
    X, Y, Z = body.occ.shape
    state0 = (init_state(body, volume_effects=sim.volume_effects_enabled)
              if state0 is None else state0.to(device))
    dtype = body.nom_pos.dtype
    u = (torch.zeros((num_knots, X, Y, Z), dtype=dtype, device=device)
         if init_u is None else torch.as_tensor(init_u, dtype=dtype, device=device))

    def resid(v):
        return _tracking_residual(v, body, sim, env, num_steps, dt, state0,
                                  target, config)

    lam = torch.as_tensor(config.lm_lambda0, dtype=dtype, device=device)
    best_cost = torch.full((), float("inf"), dtype=dtype, device=device)
    costs, accepted = [], []
    for _ in range(config.num_iters):
        u_in = u.detach().requires_grad_(True)
        with torch.enable_grad():
            r_graph = resid(u_in)
        r = r_graph.detach()
        cost = 0.5 * torch.vdot(r, r)

        def pullback(v):
            return torch.autograd.grad(r_graph, u_in, v, retain_graph=True)[0]

        def matvec(v_flat):
            _, jv = torch.func.jvp(resid, (u,), (v_flat.reshape(u.shape),))
            return pullback(jv).reshape(-1) + lam * v_flat

        rhs = -pullback(r).reshape(-1)
        delta = _cg(matvec, rhs, config.cg_iters)
        u_new = torch.clamp(u + delta.reshape(u.shape), -config.u_clip, config.u_clip)

        with torch.no_grad():
            r_new = resid(u_new)
        cost_new = 0.5 * torch.vdot(r_new, r_new)
        accept = cost_new < cost
        u = torch.where(accept, u_new, u).detach()
        lam = _lm_update(accept, lam, config)
        best_cost = torch.minimum(best_cost, torch.minimum(cost, cost_new))
        costs.append(cost)
        accepted.append(accept)

    with torch.no_grad():
        r_f = resid(u)
    return u, dict(
        final_cost=0.5 * torch.vdot(r_f, r_f),
        best_cost=best_cost,
        cost_trace=torch.stack(costs),
        accepted_trace=torch.stack(accepted),
        lm_lambda=lam,
    )


def woodbury_step(jt, r_track, u_flat, lam, w2):
    """The exact minimizer of the damped Gauss-Newton model
    (J'J + (lam + w2) I) delta = -(J' r_track + w2 u) for an explicit
    tracking Jacobian `jt` (n_res, P) with n_res << P, through one
    (n_res, n_res) solve (the Woodbury identity). Returns delta (P,)."""
    n_res = jt.shape[0]
    g = jt.T @ r_track + w2 * u_flat
    c = lam + w2
    a = jt @ jt.T + c * torch.eye(n_res, dtype=jt.dtype, device=jt.device)
    y = torch.linalg.solve(a, jt @ g)
    return -(g - jt.T @ y) / c


class FusedSQPSolver:
    """Projected Gauss-Newton/LM shooting through the fused kernels.

    Construct once per (body, sim, env, horizon) and call `.solve(target)`
    many times: the body, the start state and the stats are packed once,
    and re-planning with a new target or a warm start is launches only.

    Same formulation as `sqp_optimize` with the two structural upgrades the
    fused path makes natural (see the module docstring): Jacobian rows as
    batch rows through one backward pass, and the exact Gauss-Newton
    subproblem through `woodbury_step`. The rollout batch is `n_res` rows
    (the TPU kernel's padding of the batch to a multiple of 8 has no
    counterpart here)."""

    def __init__(self, body: VoxelBody, sim: SimParams, env: EnvParams,
                 num_steps: int, num_knots: int,
                 config: SQPConfig = SQPConfig(),
                 state0: SimState | None = None, dt=None, n_res: int = 8,
                 device=None):
        from evosoro_tpu_torch.core.materials import calc_max_dt
        from evosoro_tpu_torch.ops import fused_rollout as fr
        from evosoro_tpu_torch.ops.fused_diff import DiffRollout

        device = resolve_device(device)
        body = body.to(device)
        X, Y, Z = body.occ.shape
        state0 = (init_state(body, volume_effects=sim.volume_effects_enabled)
                  if state0 is None else state0.to(device))
        if dt is None:
            dt = calc_max_dt(body, sim.volume_effects_enabled) * sim.dt_frac
        batch = int(n_res)
        self._dr = DiffRollout(body, sim, env, num_steps=num_steps,
                               num_knots=num_knots, dt=dt, batch=batch,
                               n_segs=n_res)
        self._sp0 = fr.pack_state_single(state0)[None].expand(
            batch, -1, -1).contiguous()
        self._stats0 = self._dr.stats0
        self.seg_steps = self._dr.seg_steps
        self._shape = (X, Y, Z)
        self._n_res = int(n_res)
        self._batch = batch
        self._num_knots = int(num_knots)
        self._L = float(body.nominal_size)
        self._eye = torch.eye(n_res, batch, dtype=torch.float32, device=device)
        self.config = config
        self.device = device
        self.dt = dt

    def _cms(self, up):
        """(n_res, batch) boundary CoM-y of the batch, every row the same
        controls `up` (K, V); the batch's controls as a leaf to differentiate
        by."""
        u_rows = up[None].expand(self._batch, -1, -1).contiguous()
        u_rows.requires_grad_(torch.is_grad_enabled())
        cms, _, _ = self._dr(self._sp0, self._stats0, u_rows)
        return cms, u_rows

    def _resid(self, cms_col, tgt):
        d_cm = (cms_col - cms_col[0]) / self._L
        return self.config.w_track * (d_cm - tgt)

    def _cost(self, r_track, up):
        w2 = self.config.w_reg ** 2
        return 0.5 * (torch.vdot(r_track, r_track)
                      + w2 * torch.vdot(up.reshape(-1), up.reshape(-1)))

    def _iteration(self, up, lam, tgt):
        """One Gauss-Newton iteration from packed controls `up` (K, V):
        returns (u_new, cost, cost_new)."""
        cfg = self.config
        with torch.enable_grad():
            cms, u_rows = self._cms(up)
            # one backward, n_res Jacobian rows: row i of the cotangent
            # block selects boundary i on batch row i
            (j_rows,) = torch.autograd.grad(cms, u_rows, grad_outputs=self._eye)
        j_rows = j_rows[:self._n_res]  # (n_res, K, V) = d cm_i / d u
        jt = (j_rows - j_rows[0:1]).reshape(self._n_res, -1) * (cfg.w_track / self._L)
        r_track = self._resid(cms.detach()[:, 0], tgt)
        cost = self._cost(r_track, up)
        delta = woodbury_step(jt, r_track, up.reshape(-1), lam, cfg.w_reg ** 2)
        u_new = torch.clamp(up + delta.reshape(up.shape), -cfg.u_clip, cfg.u_clip)
        with torch.no_grad():
            cms_new, _ = self._cms(u_new)
        cost_new = self._cost(self._resid(cms_new[:, 0], tgt), u_new)
        return u_new, cost, cost_new

    def solve(self, target=0.5, init_u=None):
        """One warm-startable solve. Returns (u, info) as `sqp_optimize`;
        everything in `info` is a tensor on the solver's device."""
        cfg = self.config
        X, Y, Z = self._shape
        dev = self.device
        u0 = (torch.zeros((self._num_knots, X, Y, Z), dtype=torch.float32, device=dev)
              if init_u is None
              else torch.as_tensor(init_u, dtype=torch.float32, device=dev))
        up = self._dr.pack_controls(u0[None])[0]  # (K, V)
        tgt = _target_profile(target, self._n_res, torch.float32, dev)
        lam = torch.as_tensor(cfg.lm_lambda0, dtype=torch.float32, device=dev)
        best_cost = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        costs, accepted = [], []
        for _ in range(cfg.num_iters):
            u_new, cost, cost_new = self._iteration(up, lam, tgt)
            accept = cost_new < cost
            up = torch.where(accept, u_new, up)
            lam = _lm_update(accept, lam, cfg)
            best_cost = torch.minimum(best_cost, torch.minimum(cost, cost_new))
            costs.append(cost)
            accepted.append(accept)
        with torch.no_grad():
            cms_f, _ = self._cms(up)
        final_cost = self._cost(self._resid(cms_f[:, 0], tgt), up)
        return up.reshape(self._num_knots, X, Y, Z), dict(
            final_cost=final_cost,
            best_cost=best_cost,
            cost_trace=torch.stack(costs),
            accepted_trace=torch.stack(accepted),
            lm_lambda=lam,
        )


def sqp_optimize_fused(body: VoxelBody, sim: SimParams, env: EnvParams,
                       num_steps: int, num_knots: int, target=0.5,
                       config: SQPConfig = SQPConfig(),
                       state0: SimState | None = None, dt=None, init_u=None,
                       n_res: int = 8, device=None):
    """One-shot convenience wrapper over `FusedSQPSolver` (builds the
    solver, solves once). For repeated solves (MPC re-planning, target
    sweeps) construct `FusedSQPSolver` once and call `.solve()`."""
    solver = FusedSQPSolver(body, sim, env, num_steps, num_knots, config=config,
                            state0=state0, dt=dt, n_res=n_res, device=device)
    return solver.solve(target=target, init_u=init_u)


def sqp_optimize_multistart(generator, body: VoxelBody, sim: SimParams,
                            env: EnvParams, num_steps: int, num_knots: int,
                            n_starts: int = 8, target=0.5,
                            config: SQPConfig = SQPConfig(), dt=None,
                            init_std: float = 0.02, mesh=None, device=None):
    """Multi-start projected Gauss-Newton: `n_starts` independent
    `sqp_optimize` solves from perturbed initializations (the first start is
    the deterministic zero start), one after the other; returns the best
    (u, info) with all costs. `generator`: a `torch.Generator` on the
    solve's device (where the JAX package takes a PRNG key).

    `mesh` (a `parallel.mesh.Mesh` or a list of devices of `device`'s type,
    which may repeat one; `[device]` by default): the starts, drawn on
    `device`, are split over its entries in contiguous blocks (n_starts
    must divide by its size, as in the JAX package), each start solved on
    its entry's device; the results are gathered on `device` and the best
    start is chosen after the gather."""
    from evosoro_tpu_torch.control.shooting import _check_generator
    from evosoro_tpu_torch.parallel.mesh import as_mesh, check_mesh, row_spans, run_shards

    device = resolve_device(device)
    _check_generator(generator, device)
    mesh = check_mesh(as_mesh([device] if mesh is None else mesh), device)
    spans = row_spans(n_starts, len(mesh))
    X, Y, Z = body.occ.shape
    dtype = body.nom_pos.dtype
    u0s = init_std * torch.randn((n_starts, num_knots, X, Y, Z),
                                 generator=generator, dtype=dtype, device=device)
    u0s[0] = 0.0

    def solve(lo, hi, d):
        return [sqp_optimize(body, sim, env, num_steps, num_knots, target=target,
                             config=config, dt=dt, init_u=u0s[i], device=d)
                for i in range(lo, hi)]

    solved = [r for block in run_shards(solve, spans, mesh) for r in block]
    us = torch.stack([u.to(device) for u, _ in solved])
    costs = torch.stack([info["best_cost"].to(device) for _, info in solved])
    best = torch.argmin(costs)
    return us[best], dict(best_cost=costs[best], all_costs=costs, best_start=best)


def locomotion_sqp(body: VoxelBody, sim: SimParams, env: EnvParams,
                   num_steps: int, num_knots: int, target_dist: float,
                   warm_start_cem: bool = True, generator=None, cem_config=None,
                   sqp_config: SQPConfig = SQPConfig(), dt=None, device=None):
    """CEM global search warm-starting the SQP refiner: stochastic search
    finds the basin, Newton-type steps polish within it."""
    device = resolve_device(device)
    init_u = None
    cem_info = None
    if warm_start_cem:
        from evosoro_tpu_torch.control.shooting import CEMConfig, cem_optimize

        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        cem_config = cem_config or CEMConfig(num_iters=4, pop_size=32)
        init_u, cem_info = cem_optimize(generator, body, sim, env, num_steps,
                                        num_knots, cem_config, dt=dt,
                                        device=device)
    u, info = sqp_optimize(body, sim, env, num_steps, num_knots,
                           target=target_dist, config=sqp_config, dt=dt,
                           init_u=init_u, device=device)
    info["cem"] = cem_info
    return u, info
