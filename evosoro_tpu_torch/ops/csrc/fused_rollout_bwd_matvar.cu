// B4's material instance (nonlinear stress, the max-velocity clamp) in
// water and with growth, and its device-memory twins:
// reverse_segment<VARIANT, true> (fused_rollout_bwd.cuh) for the
// voxel-face drag, the facet drag and the development ramps, in a
// translation unit of its own linked into the fused_rollout_bwd library, so
// that B4's other kernels keep their machine code and it builds beside
// them. Its recompute is K1's material instance of the same variant
// (k1_steps with MAT); with the facet drag the tape keeps the stress
// equalization's per-side strains, and the scratch is the facet drag's.
// ma.ss and ma.bc stay null: MDL_DATA and BC regions are outside the
// envelope.
#include "fused_rollout_bwd.cuh"

template <int VARIANT, bool GMEM>
__global__ void __launch_bounds__(B4_BOUND, 1)
fused_rollout_bwd_matvar_kernel(const float* __restrict__ state_all,
                                const float* __restrict__ body_all, int body_batched,
                                const float* __restrict__ stats_all,
                                const float* __restrict__ ctrl_all, int n_knots,
                                int knot_steps, int step_base, int X, int Y, int Z,
                                int num_steps, Params p, int flags, float* tape_all,
                                float* tape_t_all, float* cot_all, float* cot_u_all,
                                float* scr_all, MatArgs ma, float* gbuf, int gstride,
                                float* sbuf, int C, int planes, int slab) {
    b4_robot<VARIANT, true, GMEM>(state_all, body_all, body_batched, stats_all, ctrl_all,
                                  n_knots, knot_steps, step_base, X, Y, Z, num_steps, p, flags,
                                  tape_all, tape_t_all, cot_all, cot_u_all, scr_all, gbuf,
                                  gstride, sbuf, C, planes, slab, ma);
}

const void* bwd_matvar_kernel(int variant, bool gmem) {
#define BWD_MK(VARIANT)                                                          \
    (gmem ? (const void*)fused_rollout_bwd_matvar_kernel<VARIANT, true>          \
          : (const void*)fused_rollout_bwd_matvar_kernel<VARIANT, false>)
    switch (variant) {
        case V_FLUID_FACE: return BWD_MK(V_FLUID_FACE);
        case V_FLUID_MESH: return BWD_MK(V_FLUID_MESH);
        default: return BWD_MK(V_DEVO);
    }
#undef BWD_MK
}

int launch_bwd_matvar(int variant, const float* state, const float* body, int body_batched,
                      const float* stats, const float* ctrl, int n_knots, int knot_steps,
                      int step_base, int B, int X, int Y, int Z, int num_steps, const Params& p,
                      int flags, float* tape, float* tape_t, float* cot, float* cot_u,
                      float* scr, float max_disp, float* gbuf, int gstride, float* sbuf, int C,
                      int threads, int planes, int slab, size_t smem, cudaStream_t st) {
    const MatArgs ma = {nullptr, nullptr, nullptr, 0, 0, max_disp};
#define GO(VARIANT)                                                                          \
    (gbuf ? b4_launch(fused_rollout_bwd_matvar_kernel<VARIANT, true>, B, C, threads, smem,   \
                      st, state, body, body_batched, stats, ctrl, n_knots, knot_steps,       \
                      step_base, X, Y, Z, num_steps, p, flags, tape, tape_t, cot, cot_u,     \
                      scr, ma, gbuf, gstride, sbuf, C, planes, slab)                         \
          : b4_launch(fused_rollout_bwd_matvar_kernel<VARIANT, false>, B, C, threads, smem,  \
                      st, state, body, body_batched, stats, ctrl, n_knots, knot_steps,       \
                      step_base, X, Y, Z, num_steps, p, flags, tape, tape_t, cot, cot_u,     \
                      scr, ma, gbuf, gstride, sbuf, C, planes, slab))
    switch (variant) {
        case V_FLUID_FACE: return GO(V_FLUID_FACE);
        case V_FLUID_MESH: return GO(V_FLUID_MESH);
        default: return GO(V_DEVO);
    }
#undef GO
}
