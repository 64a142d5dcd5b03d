// B4's kernels and their C entry: the land kernel, the fluid and
// development instances and the device-memory twins of all of them. The
// device code (the recompute, reverse_segment and the adjoint of the step)
// lives in fused_rollout_bwd.cuh, with the kernel's description; the
// material instance's kernels in fused_rollout_bwd_mat.cu (land) and
// fused_rollout_bwd_matvar.cu (water, growth), translation units of their
// own linked into the same library, so they build side by side.
#include "fused_rollout_bwd.cuh"

#ifndef EVOSORO_HOST_EMULATION
// The land, fluid and development instances (VARIANT), each in shared
// memory and as its device-memory twin (GMEM): b4_robot
template <int VARIANT, bool GMEM>
__global__ void __launch_bounds__(B4_BOUND, 1)
fused_rollout_bwd_kernel(const float* __restrict__ state_all,
                         const float* __restrict__ body_all, int body_batched,
                         const float* __restrict__ stats_all,
                         const float* __restrict__ ctrl_all, int n_knots, int knot_steps,
                         int step_base, int X, int Y, int Z, int num_steps, Params p,
                         int flags, float* tape_all, float* tape_t_all, float* cot_all,
                         float* cot_u_all, float* scr_all, float* gbuf, int gstride,
                         float* sbuf, int C, int planes, int slab) {
    b4_robot<VARIANT, false, GMEM>(state_all, body_all, body_batched, stats_all, ctrl_all,
                                   n_knots, knot_steps, step_base, X, Y, Z, num_steps, p, flags,
                                   tape_all, tape_t_all, cot_all, cot_u_all, scr_all, gbuf,
                                   gstride, sbuf, C, planes, slab, MatArgs{});
}

// B4's material instance (fused_rollout_bwd_mat.cu): its kernel, and its
// launch in the shape fused_rollout_bwd chose
const void* bwd_mat_kernel(bool gmem);
int launch_bwd_mat(const float* state, const float* body, int body_batched, const float* stats,
                   const float* ctrl, int n_knots, int knot_steps, int step_base, int B, int X,
                   int Y, int Z, int num_steps, const Params& p, int flags, float* tape,
                   float* tape_t, float* cot, float* cot_u, float max_disp, float* gbuf,
                   int gstride, float* sbuf, int C, int threads, int planes, int slab,
                   size_t smem, cudaStream_t st);

// B4's material instance in water and with growth
// (fused_rollout_bwd_matvar.cu): its kernel, and its launch
const void* bwd_matvar_kernel(int variant, bool gmem);
int launch_bwd_matvar(int variant, const float* state, const float* body, int body_batched,
                      const float* stats, const float* ctrl, int n_knots, int knot_steps,
                      int step_base, int B, int X, int Y, int Z, int num_steps, const Params& p,
                      int flags, float* tape, float* tape_t, float* cot, float* cot_u,
                      float* scr, float max_disp, float* gbuf, int gstride, float* sbuf, int C,
                      int threads, int planes, int slab, size_t smem, cudaStream_t st);

// B4's kernel for these flags: the material instance of the variant when
// the nonlinear or the clamp's bit is on, else the variant's; the
// device-memory twin (gmem) or the instance in shared memory
static const void* b4_kernel(int flags, bool gmem) {
    if (flags & (F_MAT | F_VOL))
        return variant_of(flags) == V_LAND ? bwd_mat_kernel(gmem)
                                           : bwd_matvar_kernel(variant_of(flags), gmem);
#define BWD_K(VARIANT)                                                        \
    (gmem ? (const void*)fused_rollout_bwd_kernel<VARIANT, true>              \
          : (const void*)fused_rollout_bwd_kernel<VARIANT, false>)
    switch (variant_of(flags)) {
        case V_FLUID_FACE: return BWD_K(V_FLUID_FACE);
        case V_FLUID_MESH: return BWD_K(V_FLUID_MESH);
        case V_DEVO: return BWD_K(V_DEVO);
        default: return BWD_K(V_LAND);
    }
#undef BWD_K
}

// B4's launch shape on this card for B robots of these flags on an
// X x Y x Z grid, the recompute's buffer in device memory (gmem) or in
// shared memory: out[0] the blocks a robot (C, b4_planes; cluster > 0 asks
// for that many), out[1] the threads a block, out[2] the x-planes a block
// owns, out[3] the floats of a block's slab (B4_SLAB a voxel of its
// planes), out[4] the buffer's floats a robot in device memory (BF V with
// gmem, else 0), out[5] the slabs' floats a robot in device memory (C
// slabs where a block's shared memory does not hold its slab, else 0),
// out[6] the bytes of dynamic shared memory a block, out[7] the clusters
// the card holds at once in this shape (cudaOccupancyMaxActiveClusters).
// A slab goes after the buffer in shared memory (which it may overlay) or
// alone in the twin's, where it fits; else into device memory. A shape the
// card cannot hold at all is refused, never shrunk.
static int b4_shape(int B, int X, int Y, int Z, int flags, bool gmem, int cluster, int* out) {
    const int V = X * Y * Z;
    int dev = 0, optin = 0, sms = 0;
    int rc = (int)cudaGetDevice(&dev);
    if (!rc) rc = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (!rc) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc) return rc;
    const void* kernel = b4_kernel(flags, gmem);
    const int threads = b4_threads(V);
    const size_t room = (size_t)optin - B4_STATIC_SMEM;
    // a block's dynamic shared memory with slabs of `planes` planes, and
    // whether the slabs go to device memory
    auto smem_of = [&](int planes, bool* dev_slabs) {
        const size_t slab = (size_t)B4_SLAB * planes * Y * Z * sizeof(float);
        const size_t buf = gmem ? 0 : (size_t)BF * V * sizeof(float);
        const size_t both = buf > slab ? buf : slab;
        *dev_slabs = both > room;
        return *dev_slabs ? buf : both;
    };
    auto at_once = [&](int C, int planes) {
        bool dev_slabs;
        const size_t smem = smem_of(planes, &dev_slabs);
        int n = 0;
        if (rc) return 0;
        rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
        if (rc) return 0;
        if (C == 1) {
            rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
            return n * sms;
        }
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(B * C, 1, 1);
        cfg.blockDim = dim3(threads, 1, 1);
        cfg.dynamicSmemBytes = smem;
        cudaLaunchAttribute at[1];
        at[0].id = cudaLaunchAttributeClusterDimension;
        at[0].val.clusterDim.x = C;
        at[0].val.clusterDim.y = 1;
        at[0].val.clusterDim.z = 1;
        cfg.attrs = at;
        cfg.numAttrs = 1;
        rc = (int)cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
        return n;
    };
    const int planes = b4_planes(B, X, Y, Z, threads, cluster, at_once);
    const int C = (X + planes - 1) / planes;
    const int n = at_once(C, planes);  // also leaves the kernel's attribute at this shape
    if (rc) return rc;
    if (n == 0) return (int)cudaErrorLaunchOutOfResources;
    bool dev_slabs;
    out[6] = (int)smem_of(planes, &dev_slabs);
    out[0] = C;
    out[1] = threads;
    out[2] = planes;
    out[3] = B4_SLAB * planes * Y * Z;
    out[4] = gmem ? BF * V : 0;
    out[5] = dev_slabs ? C * out[3] : 0;
    out[7] = n;
    return 0;
}

// B4's launch shape (b4_shape) for the Python side, which allocates the
// device memory it names: out[8]
extern "C" int fused_rollout_bwd_shape(int B, int X, int Y, int Z, int flags, int gmem,
                                       int cluster, int* out) {
    return b4_shape(B, X, Y, Z, flags, gmem != 0, cluster, out);
}

// state (B, C_S, V), body (B or 1, C_B, V), stats (B, C_STAT), ctrl
// (B, K, V): read only. tape (B, num_steps + 1, NT or NT_MESH, V) and
// tape_t (B, num_steps): scratch; scr (B, B4_MESH_SCR, V) with the facet
// drag, else null. cot (B, C_S, V): the END state's cotangent in, the START
// state's out. cot_u (B, K, V): zeros in, the controls' cotangent out. The
// flags pick the variant as K1's launcher does, and the material instance
// when the nonlinear or the clamp's bit is on (in every variant, with
// mparams: ops/fused_rollout.py _mat_params). gbuf: null for the
// shared-memory kernels, whose dynamic shared memory holds the recompute's
// buffer (BF * V floats); else the device-memory instance runs, robot b's
// buffer at gbuf + b * gstride (gstride >= BF * V). sbuf: the slabs in
// device memory, robot b's at sbuf + b * out[5] of b4_shape, where that
// shape puts them there (else null: they lie in shared memory). cluster:
// the blocks a robot (b4_shape with it; 0, the launcher's own choice).
extern "C" int fused_rollout_bwd(const float* state, const float* body, int body_batched,
                                 const float* stats, const float* ctrl, int n_knots,
                                 int knot_steps, int step_base, int B, int X, int Y, int Z,
                                 int num_steps, const float* params, int flags, float* tape,
                                 float* tape_t, float* cot, float* cot_u, float* scr,
                                 const float* mparams, float* gbuf, int gstride, float* sbuf,
                                 int cluster, void* stream) {
    Params p;
    memcpy(&p, params, sizeof(float) * N_PARAMS);
    const int V = X * Y * Z;
    const cudaStream_t st = (cudaStream_t)stream;
    const int variant = variant_of(flags);
    if (variant == V_FLUID_MESH && scr == nullptr) return (int)cudaErrorInvalidValue;
    int shape[8];
    const int rc = b4_shape(B, X, Y, Z, flags, gbuf != nullptr, cluster, shape);
    if (rc) return rc;
    const int C = shape[0], threads = shape[1], planes = shape[2], slab = shape[3];
    const size_t smem = (size_t)shape[6];
    if ((gbuf && (size_t)gstride < (size_t)BF * V) || (shape[5] > 0) != (sbuf != nullptr))
        return (int)cudaErrorInvalidValue;
    if (flags & (F_MAT | F_VOL)) {
        // the material instance: nonlinear stress and the clamp
        if ((flags & (F_MAT | F_VOL) & ~(F_NONLINEAR | F_MAXVEL)) || mparams == nullptr)
            return (int)cudaErrorInvalidValue;
        if (variant != V_LAND)
            return launch_bwd_matvar(variant, state, body, body_batched, stats, ctrl, n_knots,
                                     knot_steps, step_base, B, X, Y, Z, num_steps, p, flags,
                                     tape, tape_t, cot, cot_u, scr, mparams[0], gbuf, gstride,
                                     sbuf, C, threads, planes, slab, smem, st);
        return launch_bwd_mat(state, body, body_batched, stats, ctrl, n_knots, knot_steps,
                              step_base, B, X, Y, Z, num_steps, p, flags, tape, tape_t, cot,
                              cot_u, mparams[0], gbuf, gstride, sbuf, C, threads, planes, slab,
                              smem, st);
    }
#define GO(VARIANT)                                                                           \
    (gbuf ? b4_launch(fused_rollout_bwd_kernel<VARIANT, true>, B, C, threads, smem, st, state, \
                      body, body_batched, stats, ctrl, n_knots, knot_steps, step_base, X, Y, Z, \
                      num_steps, p, flags, tape, tape_t, cot, cot_u, scr, gbuf, gstride, sbuf, \
                      C, planes, slab)                                                         \
          : b4_launch(fused_rollout_bwd_kernel<VARIANT, false>, B, C, threads, smem, st,       \
                      state, body, body_batched, stats, ctrl, n_knots, knot_steps, step_base,  \
                      X, Y, Z, num_steps, p, flags, tape, tape_t, cot, cot_u, scr, gbuf,       \
                      gstride, sbuf, C, planes, slab))
    switch (variant) {
        case V_FLUID_FACE: return GO(V_FLUID_FACE);
        case V_FLUID_MESH: return GO(V_FLUID_MESH);
        case V_DEVO: return GO(V_DEVO);
        default: return GO(V_LAND);
    }
#undef GO
}
#endif
