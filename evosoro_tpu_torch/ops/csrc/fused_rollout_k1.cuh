// K1's shared-memory kernels (fused_rollout.cu) and their launches, over
// RES: fused_rollout.cu instantiates them with the state in device memory,
// fused_rollout_res.cu with the state resident in shared memory (k1_step.cuh),
// so the two halves compile side by side. Each kernel is built for one block
// an SM at its k1_bound threads and launched with k1_threads; the host
// picks whether the state is resident (ops/fused_rollout.py k1_resident).
#pragma once
#include "k1_step.cuh"

template <int VARIANT, bool FEAT, bool DENSE, bool RES>
__global__ void __launch_bounds__(k1_bound(false, DENSE, FEAT), 1)
fused_rollout_kernel(float* state_all, const float* __restrict__ body_all,
                     int body_batched, float* stats_all,
                     const float* __restrict__ a1_all, int a1_batched,
                     const float* __restrict__ ctrl_all, int n_knots,
                     int knot_steps, int step_base, int X, int Y, int Z,
                     int num_steps, Params p, int flags, float* scratch_all,
                     FeatParams fp) {
    extern __shared__ float sh[];
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    float* st = state_all + (size_t)b * C_S * V;
    const float* bo = body_all + (body_batched ? (size_t)b * C_B * V : 0);
    float* stat = stats_all + (size_t)b * C_STAT;
    const float* a1 = a1_all ? a1_all + (a1_batched ? (size_t)b * V * V : 0) : nullptr;
    const float* cu = n_knots > 0 ? ctrl_all + (size_t)b * n_knots * V : nullptr;
    float* scr = scratch_all ? scratch_all + (size_t)b * 6 * V : nullptr;

    Robot r = load_robot(stat);
    if constexpr (FEAT) {
        Feat fe = load_feat(stat);
        k1_steps<VARIANT, true, false, false, DENSE, RES>(st, bo, a1, cu, n_knots, knot_steps,
                                                          step_base, X, Y, Z, num_steps, p,
                                                          flags, r, sh, scr, &fe, &fp);
        if (threadIdx.x == 0) store_feat(stat, fe, fp, flags);
    } else {
        k1_steps<VARIANT, false, false, false, DENSE, RES>(st, bo, a1, cu, n_knots, knot_steps,
                                                           step_base, X, Y, Z, num_steps, p,
                                                           flags, r, sh, scr);
    }

    if (threadIdx.x == 0) {
        stat[ST_TIME] = r.t;
        stat[ST_DIV] = r.div ? 1.f : 0.f;
        stat[ST_INICM] = r.ini.x;
        stat[ST_INICM + 1] = r.ini.y;
        stat[ST_INICM + 2] = r.ini.z;
        stat[ST_CAPT] = r.capt ? 1.f : 0.f;
    }
}

// The material instance (VOL false) and the volume instance (VOL true): the
// land variant's step with MAT, with and without the features. Beside the
// land kernel's inputs they take the robot's MDL_DATA tables and BC
// channels (MatArgs), the volume instance the volume constants and the (B,
// 9, V) scratch (VolArgs). Contact: the dense pass on a V x V table
// (DENSE), or the compact pass on the compact (S + 1, S) one (COMPACT).
template <bool FEAT, bool VOL, bool DENSE, bool RES, bool COMPACT = false>
__global__ void __launch_bounds__(k1_bound(true, DENSE || COMPACT, FEAT), 1)
fused_rollout_mat_kernel(float* state_all, const float* __restrict__ body_all,
                         int body_batched, float* stats_all,
                         const float* __restrict__ a1_all, int a1_batched,
                         const float* __restrict__ ctrl_all, int n_knots,
                         int knot_steps, int step_base, int X, int Y, int Z,
                         int num_steps, Params p, int flags, FeatParams fp, MatArgs ma,
                         int ss_batched, int bc_batched, VolArgs va) {
    extern __shared__ float sh[];
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    float* st = state_all + (size_t)b * C_S * V;
    const float* bo = body_all + (body_batched ? (size_t)b * C_B * V : 0);
    float* stat = stats_all + (size_t)b * C_STAT;
    const size_t tab = ma.n_surf > 0 ? (size_t)(ma.n_surf + 1) * ma.n_surf : (size_t)V * V;
    const float* a1 = a1_all ? a1_all + (a1_batched ? (size_t)b * tab : 0) : nullptr;
    const float* cu = n_knots > 0 ? ctrl_all + (size_t)b * n_knots * V : nullptr;
    ma.bo = bo;
    if (ma.ss) ma.ss += ss_batched ? (size_t)b * (2 * ma.n_pts + 3) * V : 0;
    if (ma.bc) ma.bc += bc_batched ? (size_t)b * 15 * V : 0;
    if constexpr (VOL) va.scr += (size_t)b * VOL_SCR * V;
    float ke[6];
    for (int k = 0; k < 6; ++k) ke[k] = stat[ST_KE + k];

    Robot r = load_robot(stat);
    if constexpr (FEAT) {
        Feat fe = load_feat(stat);
        k1_steps<V_LAND, true, true, VOL, DENSE, RES, false, COMPACT>(
            st, bo, a1, cu, n_knots, knot_steps, step_base, X, Y, Z, num_steps, p, flags, r, sh,
            nullptr, &fe, &fp, &ma, ke, &va);
        if (threadIdx.x == 0) store_feat(stat, fe, fp, flags);
    } else {
        k1_steps<V_LAND, false, true, VOL, DENSE, RES, false, COMPACT>(
            st, bo, a1, cu, n_knots, knot_steps, step_base, X, Y, Z, num_steps, p, flags, r, sh,
            nullptr, nullptr, nullptr, &ma, ke, &va);
    }

    if (threadIdx.x == 0) {
        if (flags & F_EQUIL)
            for (int k = 0; k < 6; ++k) stat[ST_KE + k] = ke[k];
        stat[ST_TIME] = r.t;
        stat[ST_DIV] = r.div ? 1.f : 0.f;
        if constexpr (VOL) stat[ST_DT] = r.dt;
        stat[ST_INICM] = r.ini.x;
        stat[ST_INICM + 1] = r.ini.y;
        stat[ST_INICM + 2] = r.ini.z;
        stat[ST_CAPT] = r.capt ? 1.f : 0.f;
    }
}

// Dynamic shared memory of a launch: the buffer, and with RES the state
template <bool RES>
static size_t k1_smem_bytes(int V, int flags, int n_surf) {
    return (k1_buffer_floats(V, (flags & F_COLL) != 0, n_surf) + (RES ? (size_t)C_S * V : 0)) *
           sizeof(float);
}

// lets a kernel take more than 48 KB of dynamic shared memory
template <class K>
static int k1_allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
}

// Launches the shared-memory kernel the flags select, with `threads`
// threads a block (k1_threads, at most the kernel's k1_bound): the material
// and volume instances when ma is given (va with volume effects; their
// COMPACT instance for contact on a compact table), else the variant's
// kernel.
template <bool RES>
int launch_k1(float* state, const float* body, int body_batched, float* stats,
              const float* a1, int a1_batched, const float* ctrl, int n_knots, int knot_steps,
              int step_base, int B, int X, int Y, int Z, int num_steps, const Params& p,
              int flags, float* scratch, const FeatParams& fp, bool feat, const MatArgs* ma,
              int ss_batched, int bc_batched, const VolArgs* va, int threads,
              cudaStream_t stream) {
    const int V = X * Y * Z;
    const bool dense = k1_dense(flags, a1 != nullptr);
    const bool compact = ma && k1_compact(flags, a1 != nullptr);
    const size_t smem = k1_smem_bytes<RES>(V, flags, ma ? ma->n_surf : 0);
#define K1_GO(KERNEL, ...)                                                                  \
    do {                                                                                    \
        const auto k = KERNEL;                                                              \
        const int e = k1_allow_smem(k, smem);                                               \
        if (e) return e;                                                                    \
        k<<<B, threads, smem, stream>>>(__VA_ARGS__);                                       \
    } while (0)
#define MAT_GO(FEAT, VOL)                                                                   \
    K1_GO((dense     ? fused_rollout_mat_kernel<FEAT, VOL, true, RES>                      \
           : compact ? fused_rollout_mat_kernel<FEAT, VOL, false, RES, true>               \
                     : fused_rollout_mat_kernel<FEAT, VOL, false, RES>),                   \
          state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots, knot_steps,      \
          step_base, X, Y, Z, num_steps, p, flags, fp, *ma, ss_batched, bc_batched, vargs)
#define VAR_GO(VARIANT, FEAT)                                                               \
    K1_GO((dense ? fused_rollout_kernel<VARIANT, FEAT, true, RES>                          \
                 : fused_rollout_kernel<VARIANT, FEAT, false, RES>),                       \
          state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots, knot_steps,      \
          step_base, X, Y, Z, num_steps, p, flags, scratch, fp)
#define VARIANT_GO(VARIANT)      \
    if (feat)                    \
        VAR_GO(VARIANT, true);   \
    else                         \
        VAR_GO(VARIANT, false)
    if (ma) {
        const VolArgs vargs = va ? *va : VolArgs{nullptr, 0.f, 0.f, 0.f};
        if (va && feat) MAT_GO(true, true);
        else if (va) MAT_GO(false, true);
        else if (feat) MAT_GO(true, false);
        else MAT_GO(false, false);
    } else {
        switch (variant_of(flags)) {
            case V_FLUID_FACE: VARIANT_GO(V_FLUID_FACE); break;
            case V_FLUID_MESH: VARIANT_GO(V_FLUID_MESH); break;
            case V_DEVO: VARIANT_GO(V_DEVO); break;
            default: VARIANT_GO(V_LAND);
        }
    }
#undef VARIANT_GO
#undef VAR_GO
#undef MAT_GO
#undef K1_GO
    return (int)cudaGetLastError();
}
