// B4's kernels and their C entry: the land kernel, the fluid and
// development instances and the device-memory twins of all of them. The
// device code (reverse_segment and the adjoint of the step) lives in
// fused_rollout_bwd.cuh, with the kernel's description; the material
// instance's kernels in fused_rollout_bwd_mat.cu, a translation unit of
// their own linked into the same library, so that every kernel here keeps
// its machine code.
#include "fused_rollout_bwd.cuh"

#ifndef EVOSORO_HOST_EMULATION
__global__ void __launch_bounds__(MAX_THREADS)
fused_rollout_bwd_kernel(const float* __restrict__ state_all,
                         const float* __restrict__ body_all, int body_batched,
                         const float* __restrict__ stats_all,
                         const float* __restrict__ ctrl_all, int n_knots, int knot_steps,
                         int step_base, int X, int Y, int Z, int num_steps, Params p,
                         int flags, float* tape_all, float* tape_t_all, float* cot_all,
                         float* cot_u_all) {
    extern __shared__ float sh[];
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    reverse_segment<V_LAND>(state_all + (size_t)b * C_S * V,
                            body_all + (body_batched ? (size_t)b * C_B * V : 0),
                            stats_all + (size_t)b * C_STAT, ctrl_all + (size_t)b * n_knots * V,
                            n_knots, knot_steps, step_base, X, Y, Z, num_steps, p, flags,
                            tape_all + (size_t)b * (num_steps + 1) * NT * V,
                            tape_t_all + (size_t)b * num_steps, cot_all + (size_t)b * C_S * V,
                            cot_u_all + (size_t)b * n_knots * V, sh);
}

// The fluid and development instances: a kernel of their own, so that the
// land kernel's code is what it was
template <int VARIANT>
__global__ void __launch_bounds__(MAX_THREADS)
fused_rollout_bwd_var_kernel(const float* __restrict__ state_all,
                             const float* __restrict__ body_all, int body_batched,
                             const float* __restrict__ stats_all,
                             const float* __restrict__ ctrl_all, int n_knots, int knot_steps,
                             int step_base, int X, int Y, int Z, int num_steps, Params p,
                             int flags, float* tape_all, float* tape_t_all, float* cot_all,
                             float* cot_u_all, float* scr_all) {
    extern __shared__ float sh[];
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    reverse_segment<VARIANT>(
        state_all + (size_t)b * C_S * V, body_all + (body_batched ? (size_t)b * C_B * V : 0),
        stats_all + (size_t)b * C_STAT, ctrl_all + (size_t)b * n_knots * V, n_knots,
        knot_steps, step_base, X, Y, Z, num_steps, p, flags,
        tape_all + (size_t)b * (num_steps + 1) * tape_channels<VARIANT>() * V,
        tape_t_all + (size_t)b * num_steps, cot_all + (size_t)b * C_S * V,
        cot_u_all + (size_t)b * n_knots * V, sh,
        scr_all ? scr_all + (size_t)b * B4_MESH_SCR * V : nullptr);
}

// The device-memory instance of both kernels above, for bodies past one
// block's shared memory: robot b's buffer (the forward's bond forces, the
// reverse sweep's force cotangents and neighbour slabs, BF floats a voxel)
// is gbuf + b * gstride in place of dynamic shared memory; the same code on
// a generic pointer, so the same bits. A kernel of its own, so the land and
// variant kernels keep their machine code.
template <int VARIANT>
__global__ void __launch_bounds__(MAX_THREADS)
fused_rollout_bwd_gmem_kernel(const float* __restrict__ state_all,
                              const float* __restrict__ body_all, int body_batched,
                              const float* __restrict__ stats_all,
                              const float* __restrict__ ctrl_all, int n_knots, int knot_steps,
                              int step_base, int X, int Y, int Z, int num_steps, Params p,
                              int flags, float* tape_all, float* tape_t_all, float* cot_all,
                              float* cot_u_all, float* scr_all, float* gbuf, int gstride) {
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    reverse_segment<VARIANT>(
        state_all + (size_t)b * C_S * V, body_all + (body_batched ? (size_t)b * C_B * V : 0),
        stats_all + (size_t)b * C_STAT, ctrl_all + (size_t)b * n_knots * V, n_knots,
        knot_steps, step_base, X, Y, Z, num_steps, p, flags,
        tape_all + (size_t)b * (num_steps + 1) * tape_channels<VARIANT>() * V,
        tape_t_all + (size_t)b * num_steps, cot_all + (size_t)b * C_S * V,
        cot_u_all + (size_t)b * n_knots * V, gbuf + (size_t)b * gstride,
        scr_all ? scr_all + (size_t)b * B4_MESH_SCR * V : nullptr);
}

// launches B4's material instance (fused_rollout_bwd_mat.cu), or its
// device-memory twin when gbuf is given
int launch_bwd_mat(const float* state, const float* body, int body_batched, const float* stats,
                   const float* ctrl, int n_knots, int knot_steps, int step_base, int B, int X,
                   int Y, int Z, int num_steps, const Params& p, int flags, float* tape,
                   float* tape_t, float* cot, float* cot_u, float max_disp, float* gbuf,
                   int gstride, cudaStream_t st);

// state (B, C_S, V), body (B or 1, C_B, V), stats (B, C_STAT), ctrl
// (B, K, V): read only. tape (B, num_steps + 1, NT or NT_MESH, V) and
// tape_t (B, num_steps): scratch; scr (B, B4_MESH_SCR, V) with the facet
// drag, else null. cot (B, C_S, V): the END state's cotangent in, the START
// state's out. cot_u (B, K, V): zeros in, the controls' cotangent out. The
// flags pick the variant as K1's launcher does, and the material instance
// when the nonlinear or the clamp's bit is on (the land variant only, with
// mparams: ops/fused_rollout.py _mat_params). gbuf: null for the
// shared-memory kernels; else the device-memory instance runs, robot b's
// buffer at gbuf + b * gstride (gstride >= BF * V floats).
extern "C" int fused_rollout_bwd(const float* state, const float* body, int body_batched,
                                 const float* stats, const float* ctrl, int n_knots,
                                 int knot_steps, int step_base, int B, int X, int Y, int Z,
                                 int num_steps, const float* params, int flags, float* tape,
                                 float* tape_t, float* cot, float* cot_u, float* scr,
                                 const float* mparams, float* gbuf, int gstride,
                                 void* stream) {
    Params p;
    memcpy(&p, params, sizeof(float) * N_PARAMS);
    const int V = X * Y * Z;
    const int threads = V >= MAX_THREADS ? MAX_THREADS : ((V + 31) / 32) * 32;
    const size_t smem = (size_t)BF * V * sizeof(float);
    const cudaStream_t st = (cudaStream_t)stream;
    const int variant = variant_of(flags);
    if (variant == V_FLUID_MESH && scr == nullptr) return (int)cudaErrorInvalidValue;
    int rc = 0;
    if (flags & (F_MAT | F_VOL)) {
        // the material instance: nonlinear stress and the clamp on land
        if (variant != V_LAND || (flags & (F_MAT | F_VOL) & ~(F_NONLINEAR | F_MAXVEL)) ||
            mparams == nullptr)
            return (int)cudaErrorInvalidValue;
        return launch_bwd_mat(state, body, body_batched, stats, ctrl, n_knots, knot_steps,
                              step_base, B, X, Y, Z, num_steps, p, flags, tape, tape_t, cot,
                              cot_u, mparams[0], gbuf, gstride, st);
    }
    if (gbuf) {
#define GMEM_LAUNCH(VARIANT)                                                                   \
    fused_rollout_bwd_gmem_kernel<VARIANT><<<B, threads, 0, st>>>(                            \
        state, body, body_batched, stats, ctrl, n_knots, knot_steps, step_base, X, Y, Z,      \
        num_steps, p, flags, tape, tape_t, cot, cot_u, scr, gbuf, gstride)
        switch (variant) {
            case V_FLUID_FACE: GMEM_LAUNCH(V_FLUID_FACE); break;
            case V_FLUID_MESH: GMEM_LAUNCH(V_FLUID_MESH); break;
            case V_DEVO: GMEM_LAUNCH(V_DEVO); break;
            default: GMEM_LAUNCH(V_LAND);
        }
#undef GMEM_LAUNCH
        return (int)cudaGetLastError();
    }
#define VAR_LAUNCH(VARIANT)                                                                   \
    rc = allow_smem(fused_rollout_bwd_var_kernel<VARIANT>, smem);                            \
    if (rc) return rc;                                                                        \
    fused_rollout_bwd_var_kernel<VARIANT><<<B, threads, smem, st>>>(                          \
        state, body, body_batched, stats, ctrl, n_knots, knot_steps, step_base, X, Y, Z,      \
        num_steps, p, flags, tape, tape_t, cot, cot_u, scr)
    switch (variant) {
        case V_FLUID_FACE: VAR_LAUNCH(V_FLUID_FACE); break;
        case V_FLUID_MESH: VAR_LAUNCH(V_FLUID_MESH); break;
        case V_DEVO: VAR_LAUNCH(V_DEVO); break;
        default:
            rc = allow_smem(fused_rollout_bwd_kernel, smem);
            if (rc) return rc;
            fused_rollout_bwd_kernel<<<B, threads, smem, st>>>(
                state, body, body_batched, stats, ctrl, n_knots, knot_steps, step_base, X, Y,
                Z, num_steps, p, flags, tape, tape_t, cot, cot_u);
    }
#undef VAR_LAUNCH
    return (int)cudaGetLastError();
}
#endif
