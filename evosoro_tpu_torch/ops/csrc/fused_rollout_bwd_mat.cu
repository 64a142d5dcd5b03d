// B4's material instance (nonlinear stress, the max-velocity clamp) on
// land, and its device-memory twin: reverse_segment<V_LAND, true>
// (fused_rollout_bwd.cuh), in a translation unit of its own linked into the
// fused_rollout_bwd library, so that it builds beside fused_rollout_bwd.cu.
// ma.ss and ma.bc stay null: MDL_DATA and BC regions are outside the
// envelope.
#include "fused_rollout_bwd.cuh"

template <bool GMEM>
__global__ void __launch_bounds__(B4_BOUND, 1)
fused_rollout_bwd_mat_kernel(const float* __restrict__ state_all,
                             const float* __restrict__ body_all, int body_batched,
                             const float* __restrict__ stats_all,
                             const float* __restrict__ ctrl_all, int n_knots, int knot_steps,
                             int step_base, int X, int Y, int Z, int num_steps, Params p,
                             int flags, float* tape_all, float* tape_t_all, float* cot_all,
                             float* cot_u_all, MatArgs ma, float* gbuf, int gstride,
                             float* sbuf, int C, int planes, int slab) {
    b4_robot<V_LAND, true, GMEM>(state_all, body_all, body_batched, stats_all, ctrl_all,
                                 n_knots, knot_steps, step_base, X, Y, Z, num_steps, p, flags,
                                 tape_all, tape_t_all, cot_all, cot_u_all, nullptr, gbuf,
                                 gstride, sbuf, C, planes, slab, ma);
}

const void* bwd_mat_kernel(bool gmem) {
    return gmem ? (const void*)fused_rollout_bwd_mat_kernel<true>
                : (const void*)fused_rollout_bwd_mat_kernel<false>;
}

int launch_bwd_mat(const float* state, const float* body, int body_batched, const float* stats,
                   const float* ctrl, int n_knots, int knot_steps, int step_base, int B, int X,
                   int Y, int Z, int num_steps, const Params& p, int flags, float* tape,
                   float* tape_t, float* cot, float* cot_u, float max_disp, float* gbuf,
                   int gstride, float* sbuf, int C, int threads, int planes, int slab,
                   size_t smem, cudaStream_t st) {
    const MatArgs ma = {nullptr, nullptr, nullptr, 0, 0, max_disp};
    if (gbuf)
        return b4_launch(fused_rollout_bwd_mat_kernel<true>, B, C, threads, smem, st, state,
                         body, body_batched, stats, ctrl, n_knots, knot_steps, step_base, X, Y,
                         Z, num_steps, p, flags, tape, tape_t, cot, cot_u, ma, gbuf, gstride,
                         sbuf, C, planes, slab);
    return b4_launch(fused_rollout_bwd_mat_kernel<false>, B, C, threads, smem, st, state, body,
                     body_batched, stats, ctrl, n_knots, knot_steps, step_base, X, Y, Z,
                     num_steps, p, flags, tape, tape_t, cot, cot_u, ma, gbuf, gstride, sbuf, C,
                     planes, slab);
}
