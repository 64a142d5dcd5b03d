// K1's shared-memory kernels with the robot's state resident in shared
// memory across the launch (k1_step.cuh, RES): a translation unit of its own
// in the fused_rollout library, so the two halves of K1's kernels build side
// by side (ops/build.py starts one nvcc a unit). fused_rollout.cu launches
// them when the host asks for the resident state (ops/fused_rollout.py
// k1_resident).
#include "fused_rollout_k1.cuh"

int launch_res(float* state, const float* body, int body_batched, float* stats,
               const float* a1, int a1_batched, const float* ctrl, int n_knots, int knot_steps,
               int step_base, int B, int X, int Y, int Z, int num_steps, const Params& p,
               int flags, float* scratch, const FeatParams& fp, bool feat, const MatArgs* ma,
               int ss_batched, int bc_batched, const VolArgs* va, int threads,
               cudaStream_t stream) {
    return launch_k1<true>(state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots,
                           knot_steps, step_base, B, X, Y, Z, num_steps, p, flags, scratch, fp,
                           feat, ma, ss_batched, bc_batched, va, threads, stream);
}
