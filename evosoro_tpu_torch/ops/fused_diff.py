"""Differentiable fused rollout: a segment-level `torch.autograd.Function`
over the fused rollout kernels.

The port of `evosoro_tpu/ops/fused_diff.py`. The forward pass advances the
rollout in segments of `seg_steps` steps, one K1 launch each
(`fused_rollout.fused_call` in segmented mode); the CoM-y at every segment
boundary is the differentiable observable (the SQP tracking residual's
trace points). The backward pass of a segment is one launch of the
reverse-mode segment kernel B4 (`fused_rollout.fused_bwd_call`): the saved
segment-START state is the checkpoint, the kernel recomputes the segment
forward into a tape and pulls the state cotangent back step by step with
the hand-written adjoint of the step, so autograd keeps O(n_segs) packed
states and never sees the steps.

On CPU tensors the two wrappers run their plain versions (the eager step
and torch autograd through it), so gradients mean the same on both devices:
BPTT through `core.rollout`, the same float32 numerics and piecewise
branches.

The envelope is B4's (`fused_rollout.diff_envelope_ok`): on land, in water
with either drag model, and with the development ramps; in each of them
also with bilinear materials (a palette that is not all linear) and the
max-velocity clamp (`SimParams.max_velocity_enabled`), through B4's
material instance of that variant.
The flags come from the body and the environment as in the JAX package's
`DiffRollout`: the facet drag when the body carries mesh tables in a fluid
(which needs the grid's +X/+Y/+Z shell), the development flags from the
body's fields, `nonlinear` from the palette. Outside the envelope the
constructor raises ValueError naming the flag, as the JAX package's does
without the name; unlike the JAX package's, a body with MDL_DATA materials
or BC regions is refused too (the JAX `DiffRollout` sets those two flags
off and runs such a body as if it had neither).
"""

from __future__ import annotations

import torch

from evosoro_tpu_torch.core.constants import DEFAULT_PRECISION, Precision
from evosoro_tpu_torch.core.types import EnvParams, SimParams, VoxelBody
from evosoro_tpu_torch.ops import fused_rollout as fr


class _Segment(torch.autograd.Function):
    """One segment: (state, stats, controls) -> (state, stats) through K1,
    with B4 as its backward. Stats are rollout constants (dt, per-robot env
    scalars, clocks): no control gradient flows through them."""

    @staticmethod
    def forward(ctx, state_p, stats, ctrl_p, seg_base, body_packed, kw):
        out_state, out_stats = fr.fused_call(
            state_p, body_packed, stats, None, control_packed=ctrl_p,
            seg_base=seg_base, **kw)
        ctx.save_for_backward(state_p, stats, ctrl_p, body_packed)
        ctx.seg_base, ctx.kw = seg_base, kw
        ctx.mark_non_differentiable(out_stats)
        return out_state, out_stats

    @staticmethod
    def backward(ctx, cot_state, _cot_stats):
        state_p, stats, ctrl_p, body_packed = ctx.saved_tensors
        if cot_state is None:
            cot_state = torch.zeros_like(state_p)
        cot_state_in, cot_ctrl = fr.fused_bwd_call(
            state_p, body_packed, stats, ctrl_p, ctx.seg_base,
            cot_state.contiguous(), **ctx.kw)
        return cot_state_in, None, cot_ctrl, None, None, None


class DiffRollout:
    """Segmented differentiable rollout for one design.

    `__call__(state_packed, stats, ctrl_packed)` returns
    `(cm_y_trace, final_state_packed, final_stats)` where `cm_y_trace` is
    the (n_segs, B) CoM-y at every segment boundary, differentiable with
    respect to `state_packed` and `ctrl_packed`."""

    def __init__(self, body: VoxelBody, sim: SimParams, env: EnvParams,
                 num_steps: int, num_knots: int, dt, batch: int, stop_time=None,
                 n_segs: int = 8, prec: Precision = DEFAULT_PRECISION):
        # the flags first: a facet-drag body without its shell raises by name
        flags = fr.launch_flags(body, sim, env, collision=False, segmented=True)
        if not fr.supports(body, sim, env):
            raise ValueError("configuration outside the fused envelope")
        X, Y, Z = body.occ.shape
        self.grid_shape = (X, Y, Z)
        self.batch = batch
        self.num_knots = int(num_knots)
        self.seg_steps = -(-int(num_steps) // int(n_segs))
        self.n_segs = int(n_segs)
        self.total_steps = self.seg_steps * self.n_segs
        self.body = body
        self.nominal_size = body.nominal_size

        self.body_packed = fr.pack_body(body)
        self.stats0 = fr.make_stats(body, batch, dt, sim, env, stop_time)
        scalars = fr.kernel_scalars(body.nominal_size, sim, env)
        why = fr._diff_refusal(flags, scalars)
        if why is not None:
            raise ValueError(
                f"configuration outside the differentiable-kernel envelope: {why} "
                "(see fused_rollout.diff_envelope_ok)")
        self._kw = dict(num_steps=self.seg_steps, grid_shape=self.grid_shape,
                        scalars=scalars, flags=flags, n_knots=self.num_knots,
                        total_steps=self.total_steps, prec=prec)

    def init_packed(self, state):
        """Batched SimState -> packed (B, C_S, V) float32."""
        return fr.pack_state(state)

    def pack_controls(self, u):
        """(B, K, X, Y, Z) control knots -> packed (B, K, V)."""
        u = torch.as_tensor(u, dtype=torch.float32,
                            device=self.body_packed.device)
        return fr._flat(u, tuple(u.shape[:2]))

    def cm_y(self, state_p, stats):
        mass = self.body_packed[:, fr._B_MASS, :]
        return (state_p[:, fr._POS + 1, :] * mass).sum(1) * stats[:, fr._S_INV_MASS]

    def __call__(self, state_p, stats, ctrl_p):
        cms = []
        for s in range(self.n_segs):
            state_p, stats = _Segment.apply(
                state_p, stats, ctrl_p, s * self.seg_steps, self.body_packed,
                self._kw)
            cms.append(self.cm_y(state_p, stats))
        return torch.stack(cms), state_p, stats
