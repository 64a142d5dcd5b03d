// K1's material and volume instances in water and with growth: the step
// loop k1_steps (k1_step.cuh) with MAT in the voxel-face drag, facet drag
// and development variants, with and without the features and volume
// effects, without contact, with the dense pair pass or with the compact
// one, each in shared memory and as its device-memory twin. They replace
// evosoro_tpu/ops/fused_rollout.py, _make_kernel with its material and
// volume options (:513-573, :907-910, :966-998, :1011-1019, :1178-1322,
// :1347, :1519-1605) in the fluid and development variants (:1373-1469,
// :1610-1705).
//
// Each variant's kernels compile in two translation units of their own
// (fused_rollout_mat_<variant>.cu: shared memory; ..._gmem.cu: the twins),
// so the land material kernels and every other K1 kernel keep their machine
// code, and the six units build side by side with the others. There is no
// resident-state half: the state stays in device memory (the host's
// k1_resident answers no for these flags). That is a speed choice, not an
// envelope one.
//
// Inputs: those of the land material kernels (fused_rollout_k1.cuh
// fused_rollout_mat_kernel, fused_rollout_gmem.cu), plus the facet drag's
// (B, 6, V) scratch of per-side bond strains (V_FLUID_MESH only), which is
// a device buffer apart from the volume instance's (B, VOL_SCR, V) one.
#pragma once
#include "k1_step.cuh"

template <int VARIANT, bool FEAT, bool VOL, bool DENSE, bool COMPACT, bool GMEM>
__global__ void __launch_bounds__(k1_bound(true, DENSE || COMPACT, FEAT), 1)
fused_rollout_matvar_kernel(float* state_all, const float* __restrict__ body_all,
                            int body_batched, float* stats_all,
                            const float* __restrict__ a1_all, int a1_batched,
                            const float* __restrict__ ctrl_all, int n_knots, int knot_steps,
                            int step_base, int X, int Y, int Z, int num_steps, Params p,
                            int flags, float* scratch_all, FeatParams fp, MatArgs ma,
                            int ss_batched, int bc_batched, VolArgs va, float* gbuf,
                            int gstride) {
    extern __shared__ float sh[];
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    float* buf = GMEM ? gbuf + (size_t)b * gstride : sh;
    float* st = state_all + (size_t)b * C_S * V;
    const float* bo = body_all + (body_batched ? (size_t)b * C_B * V : 0);
    float* stat = stats_all + (size_t)b * C_STAT;
    const size_t tab = ma.n_surf > 0 ? (size_t)(ma.n_surf + 1) * ma.n_surf : (size_t)V * V;
    const float* a1 = a1_all ? a1_all + (a1_batched ? (size_t)b * tab : 0) : nullptr;
    const float* cu = n_knots > 0 ? ctrl_all + (size_t)b * n_knots * V : nullptr;
    float* scr = VARIANT == V_FLUID_MESH ? scratch_all + (size_t)b * 6 * V : nullptr;
    ma.bo = bo;
    if (ma.ss) ma.ss += ss_batched ? (size_t)b * (2 * ma.n_pts + 3) * V : 0;
    if (ma.bc) ma.bc += bc_batched ? (size_t)b * 15 * V : 0;
    if constexpr (VOL) va.scr += (size_t)b * VOL_SCR * V;
    float ke[6];
    for (int k = 0; k < 6; ++k) ke[k] = stat[ST_KE + k];

    Robot r = load_robot(stat);
    if constexpr (FEAT) {
        Feat fe = load_feat(stat);
        k1_steps<VARIANT, true, true, VOL, DENSE, false, false, COMPACT>(
            st, bo, a1, cu, n_knots, knot_steps, step_base, X, Y, Z, num_steps, p, flags, r, buf,
            scr, &fe, &fp, &ma, ke, &va);
        if (threadIdx.x == 0) store_feat(stat, fe, fp, flags);
    } else {
        k1_steps<VARIANT, false, true, VOL, DENSE, false, false, COMPACT>(
            st, bo, a1, cu, n_knots, knot_steps, step_base, X, Y, Z, num_steps, p, flags, r, buf,
            scr, nullptr, nullptr, &ma, ke, &va);
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

// The launch of one variant's instances, in shared memory or (GMEM) in
// device memory, robot b's buffer at gbuf + b * gstride: the instance the
// flags and the table pick, as launch_k1 and launch_gmem pick the land one
template <int VARIANT, bool GMEM>
int launch_matvar(float* state, const float* body, int body_batched, float* stats,
                  const float* a1, int a1_batched, const float* ctrl, int n_knots,
                  int knot_steps, int step_base, int B, int X, int Y, int Z, int num_steps,
                  const Params& p, int flags, float* scratch, const FeatParams& fp, bool feat,
                  const MatArgs* ma, int ss_batched, int bc_batched, const VolArgs* va,
                  float* gbuf, int gstride, int threads, cudaStream_t stream) {
    const int V = X * Y * Z;
    const bool dense = k1_dense(flags, a1 != nullptr);
    const bool compact = k1_compact(flags, a1 != nullptr);
    const size_t smem =
        GMEM ? 0 : k1_buffer_floats(V, (flags & F_COLL) != 0, ma->n_surf) * sizeof(float);
    const VolArgs vargs = va ? *va : VolArgs{nullptr, 0.f, 0.f, 0.f};
#define MATVAR_GO(FEAT, VOL)                                                                  \
    do {                                                                                      \
        const auto k = dense     ? fused_rollout_matvar_kernel<VARIANT, FEAT, VOL, true, false, GMEM>  \
                       : compact ? fused_rollout_matvar_kernel<VARIANT, FEAT, VOL, false, true, GMEM>  \
                                 : fused_rollout_matvar_kernel<VARIANT, FEAT, VOL, false, false, GMEM>; \
        if (smem > 48 * 1024) {                                                               \
            const int e = (int)cudaFuncSetAttribute(                                          \
                k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);                   \
            if (e) return e;                                                                  \
        }                                                                                     \
        k<<<B, threads, smem, stream>>>(state, body, body_batched, stats, a1, a1_batched,    \
                                        ctrl, n_knots, knot_steps, step_base, X, Y, Z,        \
                                        num_steps, p, flags, scratch, fp, *ma, ss_batched,    \
                                        bc_batched, vargs, gbuf, gstride);                    \
    } while (0)
    if (va && feat) MATVAR_GO(true, true);
    else if (va) MATVAR_GO(false, true);
    else if (feat) MATVAR_GO(true, false);
    else MATVAR_GO(false, false);
#undef MATVAR_GO
    return (int)cudaGetLastError();
}

// The signature of each unit's launcher (fused_rollout.cu picks one by the
// variant and by whether the host handed it a buffer in device memory)
#define K1_MATVAR_ARGS                                                                       \
    float *state, const float *body, int body_batched, float *stats, const float *a1,        \
        int a1_batched, const float *ctrl, int n_knots, int knot_steps, int step_base, int B, \
        int X, int Y, int Z, int num_steps, const Params &p, int flags, float *scratch,       \
        const FeatParams &fp, bool feat, const MatArgs *ma, int ss_batched, int bc_batched,   \
        const VolArgs *va, float *gbuf, int gstride, int threads, cudaStream_t stream
#define K1_MATVAR_UNIT(NAME, VARIANT, GMEM)                                                  \
    int NAME(K1_MATVAR_ARGS) {                                                                \
        return launch_matvar<VARIANT, GMEM>(state, body, body_batched, stats, a1, a1_batched, \
                                            ctrl, n_knots, knot_steps, step_base, B, X, Y, Z, \
                                            num_steps, p, flags, scratch, fp, feat, ma,       \
                                            ss_batched, bc_batched, va, gbuf, gstride,        \
                                            threads, stream);                                 \
    }
