// K1's device-memory instances, for bodies past one block's shared memory.
//
// Replaces: evosoro_tpu/ops/fused_rollout.py, _make_kernel (forward branch)
// as launched by _fused_call at the sizes where its VMEM still holds a robot
// and this card's shared memory does not: the JAX kernel runs any body
// without contact and up to 2304 lanes (a 13^3 body) with it
// (`collision_batch_block`). Every kernel of fused_rollout.cu has a twin
// here: fused_rollout_gmem_kernel<VARIANT, FEAT> (the land, face-drag,
// facet-drag and development variants, with and without the features) and
// fused_rollout_mat_gmem_kernel<FEAT, VOL> (the material and volume
// instances). Each hands rollout_steps (fused_rollout_common.cuh) the
// robot's slice of a (B, F, V) buffer in device memory in place of dynamic
// shared memory, F = BF, + 7 with contact, + 3 and 4 S / V with the compact
// pass: the same carve. The step is the same code on a generic pointer, so
// it computes the same bits; a barrier orders the block's global stores and
// loads as it orders shared ones. The static shared memory (the
// reductions' scratch, the window ring) stays on chip. The host picks the
// instance by shape (ops/fused_rollout.py k1_instance) and fused_rollout()
// launches it, with no dynamic shared memory, when it is handed the buffer.
//
// A translation unit of its own in the library: in one unit with the
// kernels of fused_rollout.cu, these twins changed the machine code of the
// six feature kernels there (the same bits, other SASS: buildcmp); apart,
// every kernel of fused_rollout.cu compiles to what it was.
//
// Bound on this card: as the shared instance, the latency of a block's
// step, now with the bond traffic through L2 (43 floats a voxel with
// contact: 297 KB a 12^3 robot, 39 MB for the 132 robots of a wave, inside
// the card's 50 MB; 378 KB and ~50 MB at 13^3). Forced on 1024 x 10^3 x
// 200 steps it takes 1.47 x the shared instance's time (89.1 against 60.6
// ms, NVIDIA H100 80GB HBM3, 700 W): the price of the buffer's place. A
// cluster of blocks sharing the robot through distributed shared memory
// would keep it on chip.
#include "fused_rollout_common.cuh"

// The device-memory instance of fused_rollout_kernel: robot b's bond
// buffer is gbuf + b * gstride (gstride floats, at least F * V).
template <int VARIANT, bool FEAT>
__global__ void __launch_bounds__(MAX_THREADS)
fused_rollout_gmem_kernel(float* state_all, const float* __restrict__ body_all,
                          int body_batched, float* stats_all,
                          const float* __restrict__ a1_all, int a1_batched,
                          const float* __restrict__ ctrl_all, int n_knots,
                          int knot_steps, int step_base, int X, int Y, int Z,
                          int num_steps, Params p, int flags, float* scratch_all,
                          FeatParams fp, float* gbuf, int gstride) {
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    float* buf = gbuf + (size_t)b * gstride;
    float* st = state_all + (size_t)b * C_S * V;
    const float* bo = body_all + (body_batched ? (size_t)b * C_B * V : 0);
    float* stat = stats_all + (size_t)b * C_STAT;
    const float* a1 = a1_all ? a1_all + (a1_batched ? (size_t)b * V * V : 0) : nullptr;
    const float* cu = n_knots > 0 ? ctrl_all + (size_t)b * n_knots * V : nullptr;
    float* scr = scratch_all ? scratch_all + (size_t)b * 6 * V : nullptr;

    Robot r = load_robot(stat);
    if constexpr (FEAT) {
        Feat fe = load_feat(stat);
        rollout_steps<VARIANT, true>(st, 0, bo, a1, cu, n_knots, knot_steps, step_base, X, Y,
                                     Z, num_steps, p, flags, r, nullptr, buf, scr, &fe, &fp);
        if (threadIdx.x == 0) store_feat(stat, fe, fp, flags);
    } else {
        rollout_steps<VARIANT>(st, 0, bo, a1, cu, n_knots, knot_steps, step_base, X, Y, Z,
                               num_steps, p, flags, r, nullptr, buf, scr);
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

// The device-memory instance of the material (VOL false) and volume (VOL
// true) kernels.
template <bool FEAT, bool VOL>
__global__ void __launch_bounds__(MAX_THREADS)
fused_rollout_mat_gmem_kernel(float* state_all, const float* __restrict__ body_all,
                              int body_batched, float* stats_all,
                              const float* __restrict__ a1_all, int a1_batched,
                              const float* __restrict__ ctrl_all, int n_knots,
                              int knot_steps, int step_base, int X, int Y, int Z,
                              int num_steps, Params p, int flags, FeatParams fp, MatArgs ma,
                              int ss_batched, int bc_batched, VolArgs va, float* gbuf,
                              int gstride) {
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    float* buf = gbuf + (size_t)b * gstride;
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
        rollout_steps<V_LAND, true, true, VOL>(st, 0, bo, a1, cu, n_knots, knot_steps,
                                               step_base, X, Y, Z, num_steps, p, flags, r,
                                               nullptr, buf, nullptr, &fe, &fp, &ma, ke, &va);
        if (threadIdx.x == 0) store_feat(stat, fe, fp, flags);
    } else {
        rollout_steps<V_LAND, false, true, VOL>(st, 0, bo, a1, cu, n_knots, knot_steps,
                                                step_base, X, Y, Z, num_steps, p, flags, r,
                                                nullptr, buf, nullptr, nullptr, nullptr, &ma,
                                                ke, &va);
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

// launches the device-memory instance the flags select (no dynamic shared
// memory); declared in fused_rollout.cu
int launch_gmem(float* state, const float* body, int body_batched, float* stats,
                const float* a1, int a1_batched, const float* ctrl, int n_knots, int knot_steps,
                int step_base, int B, int X, int Y, int Z, int num_steps, const Params& p,
                int flags, float* scratch, const FeatParams& fp, bool feat, const MatArgs* ma,
                int ss_batched, int bc_batched, const VolArgs* va, float* gbuf, int gstride,
                cudaStream_t st) {
    const int V = X * Y * Z;
    const int threads = V >= MAX_THREADS ? MAX_THREADS : ((V + 31) / 32) * 32;
#define MAT_GMEM(FEAT, VOL)                                                                   \
    fused_rollout_mat_gmem_kernel<FEAT, VOL><<<B, threads, 0, st>>>(                         \
        state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots, knot_steps,          \
        step_base, X, Y, Z, num_steps, p, flags, fp, *ma, ss_batched, bc_batched, vargs, gbuf, \
        gstride)
#define VAR_GMEM(VARIANT, FEAT)                                                               \
    fused_rollout_gmem_kernel<VARIANT, FEAT><<<B, threads, 0, st>>>(                         \
        state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots, knot_steps,          \
        step_base, X, Y, Z, num_steps, p, flags, scratch, fp, gbuf, gstride)
#define VARIANT_GMEM(VARIANT) \
    if (feat)                 \
        VAR_GMEM(VARIANT, true); \
    else                      \
        VAR_GMEM(VARIANT, false)
    if (ma) {
        const VolArgs vargs = va ? *va : VolArgs{nullptr, 0.f, 0.f, 0.f};
        if (va && feat) MAT_GMEM(true, true);
        else if (va) MAT_GMEM(false, true);
        else if (feat) MAT_GMEM(true, false);
        else MAT_GMEM(false, false);
    } else {
        switch (variant_of(flags)) {
            case V_FLUID_FACE: VARIANT_GMEM(V_FLUID_FACE); break;
            case V_FLUID_MESH: VARIANT_GMEM(V_FLUID_MESH); break;
            case V_DEVO: VARIANT_GMEM(V_DEVO); break;
            default: VARIANT_GMEM(V_LAND);
        }
    }
#undef VARIANT_GMEM
#undef VAR_GMEM
#undef MAT_GMEM
    return (int)cudaGetLastError();
}
