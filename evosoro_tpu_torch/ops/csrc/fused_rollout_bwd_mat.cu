// B4's material instance (nonlinear stress, the max-velocity clamp) on
// land, and its device-memory twin: reverse_segment<V_LAND, true>
// (fused_rollout_bwd.cuh), in a translation unit of its own linked into the
// fused_rollout_bwd library, so that the kernels of fused_rollout_bwd.cu
// keep their machine code (as K1's twins in fused_rollout_gmem.cu). ma.ss
// and ma.bc stay null: MDL_DATA and BC regions are outside the envelope.
#include "fused_rollout_bwd.cuh"

__global__ void __launch_bounds__(MAX_THREADS)
fused_rollout_bwd_mat_kernel(const float* __restrict__ state_all,
                             const float* __restrict__ body_all, int body_batched,
                             const float* __restrict__ stats_all,
                             const float* __restrict__ ctrl_all, int n_knots, int knot_steps,
                             int step_base, int X, int Y, int Z, int num_steps, Params p,
                             int flags, float* tape_all, float* tape_t_all, float* cot_all,
                             float* cot_u_all, MatArgs ma) {
    extern __shared__ float sh[];
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    ma.bo = body_all + (body_batched ? (size_t)b * C_B * V : 0);
    reverse_segment<V_LAND, true>(state_all + (size_t)b * C_S * V, ma.bo,
                                  stats_all + (size_t)b * C_STAT,
                                  ctrl_all + (size_t)b * n_knots * V, n_knots, knot_steps,
                                  step_base, X, Y, Z, num_steps, p, flags,
                                  tape_all + (size_t)b * (num_steps + 1) * NT * V,
                                  tape_t_all + (size_t)b * num_steps,
                                  cot_all + (size_t)b * C_S * V,
                                  cot_u_all + (size_t)b * n_knots * V, sh, nullptr, &ma);
}

__global__ void __launch_bounds__(MAX_THREADS)
fused_rollout_bwd_mat_gmem_kernel(const float* __restrict__ state_all,
                                  const float* __restrict__ body_all, int body_batched,
                                  const float* __restrict__ stats_all,
                                  const float* __restrict__ ctrl_all, int n_knots,
                                  int knot_steps, int step_base, int X, int Y, int Z,
                                  int num_steps, Params p, int flags, float* tape_all,
                                  float* tape_t_all, float* cot_all, float* cot_u_all,
                                  MatArgs ma, float* gbuf, int gstride) {
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    ma.bo = body_all + (body_batched ? (size_t)b * C_B * V : 0);
    reverse_segment<V_LAND, true>(state_all + (size_t)b * C_S * V, ma.bo,
                                  stats_all + (size_t)b * C_STAT,
                                  ctrl_all + (size_t)b * n_knots * V, n_knots, knot_steps,
                                  step_base, X, Y, Z, num_steps, p, flags,
                                  tape_all + (size_t)b * (num_steps + 1) * NT * V,
                                  tape_t_all + (size_t)b * num_steps,
                                  cot_all + (size_t)b * C_S * V,
                                  cot_u_all + (size_t)b * n_knots * V,
                                  gbuf + (size_t)b * gstride, nullptr, &ma);
}

int launch_bwd_mat(const float* state, const float* body, int body_batched, const float* stats,
                   const float* ctrl, int n_knots, int knot_steps, int step_base, int B, int X,
                   int Y, int Z, int num_steps, const Params& p, int flags, float* tape,
                   float* tape_t, float* cot, float* cot_u, float max_disp, float* gbuf,
                   int gstride, cudaStream_t st) {
    const int V = X * Y * Z;
    const int threads = V >= MAX_THREADS ? MAX_THREADS : ((V + 31) / 32) * 32;
    const MatArgs ma = {nullptr, nullptr, nullptr, 0, 0, max_disp};
    if (gbuf) {
        fused_rollout_bwd_mat_gmem_kernel<<<B, threads, 0, st>>>(
            state, body, body_batched, stats, ctrl, n_knots, knot_steps, step_base, X, Y, Z,
            num_steps, p, flags, tape, tape_t, cot, cot_u, ma, gbuf, gstride);
        return (int)cudaGetLastError();
    }
    const size_t smem = (size_t)BF * V * sizeof(float);
    const int rc = allow_smem(fused_rollout_bwd_mat_kernel, smem);
    if (rc) return rc;
    fused_rollout_bwd_mat_kernel<<<B, threads, smem, st>>>(
        state, body, body_batched, stats, ctrl, n_knots, knot_steps, step_base, X, Y, Z,
        num_steps, p, flags, tape, tape_t, cot, cot_u, ma);
    return (int)cudaGetLastError();
}
