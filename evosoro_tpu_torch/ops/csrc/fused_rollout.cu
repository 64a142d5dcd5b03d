// K1: fused forward rollout, B robots x num_steps in one launch.
//
// Replaces: evosoro_tpu/ops/fused_rollout.py, _make_kernel (forward branch)
// as launched by _fused_call, restricted to the evolution loop's envelope:
// linear materials, floor with Coulomb friction and the sticky floor,
// gravity, thermal actuation with the mid-life freeze, and self-collision
// through the dense pair pass of pair_contact.cuh (K2); beside it the fluid
// environment (facet drag on the deformed surface mesh, voxel-face drag,
// the land_water actuation) and the linear development ramps, each a
// variant of the step compiled on its own (fused_rollout_common.cuh). The
// host wrapper refuses every other feature flag. It also carries that kernel's MPC
// control-knot channel and segmented mode (:1061, :1119, :1710-1719): step i
// of a launch is global step step_base + i of a rollout whose knot clock
// runs over knot_steps steps; the robot's controls (B, K, V) modulate each
// occupied voxel's scale by u * L after the actuation clamps, with the knot
// min(global step * K / knot_steps, K - 1). The TPU kernel holds the K knot
// rows in on-chip memory and blends them with a one-hot sum; here the
// block computes the knot once a step and each voxel's thread loads its
// value from device memory (the controls of a CEM population stay in L2),
// so the channel costs no shared memory. With K = 0 nothing else changes.
//
// Each step computes what core/step.py:sim_step computes, in the same
// order of operations: three beam-bond passes (small/large-angle
// hysteresis, bond damping, max-strain memory), the force sum with slow
// damping, contact, gravity and floor, the Euler step, moments, the
// angular integration with the quaternion update and its identity snap,
// and the actuation scale update with its clamps. Around it run the
// rollout's bookkeeping of the TPU kernel: the IniCM capture from the
// previous step's positions (seeded at global step 0), the strain > 100
// divergence latch and the per-robot stop-time freeze.
//
// Layout: the packed channel-major tensors of the host side, with V = X*Y*Z
// voxels in flat x-major order and no padding: state (B, 64, V), body
// (B or 1, 88, V), stats (B, 48), pair table (B or 1, V, V).
//
// Design: one block per robot, threads stride over its voxels, and the step
// loop runs inside the kernel, so a rollout is one launch and every stencil
// neighbour lies in the same block. Per step: phase A computes each bond
// (v, d) once and keeps its f1, m1 (for v) and f2, m2 (for v + stride_d) in
// shared memory (36 floats a voxel); with collision on, positions and
// scales are staged in shared memory (a float4 a voxel, padded to whole
// 32-voxel groups) beside the pair pass's tile mask and boxes
// (pair_contact.cuh), and the pass writes its forces there too (3 floats
// a voxel; k1_buffer_floats). After a barrier, phase B sums the
// forces of each voxel and integrates it in place. The CoM for the IniCM
// capture and the divergence test are block reductions. Frozen robots leave
// the loop.
//
// Bound on this card: the latency of one block's step. The state (and the
// body, when it is not shared) is read from and written to device memory
// every step, ~0.4 KB a voxel-step, and only the bond forces stay on chip;
// but at 10^3 voxels the 144 KB of shared memory leave one 256-thread block
// on each SM, and a step takes ~40 us whether the batch's state fits in L2
// (132 robots) or streams from HBM (1024 robots), so the chain of dependent
// loads and barriers within a block sets the time, not the bytes. With
// collision on, the pair pass (pair_contact.cuh) reads the robot's table
// once a launch for a static tile mask, culls 32 x 32 tiles by their
// groups' boxes every step and walks the hot ones a row a lane, the next
// tile's loads in flight. Every kernel has an instance with the pass
// (DENSE, launched for contact on a dense table: k1_dense) and one
// without, so launches without contact keep their registers (the pass
// takes K1 to 205-255). Shared memory caps V at 1613 cells (1612 in the
// feature instance, whose window ring takes 96 bytes), 1339 with
// collision; past that the device-memory instances (fused_rollout_gmem.cu)
// run the body. Keeping the state resident on chip across steps and more
// warps per SM are the levers.
//
// Numerics: built with -fmad=false and without fast math, so every multiply
// and add rounds as in PyTorch's eager ops and sinf/acosf/sqrtf/division
// are the same IEEE-accurate functions torch uses on the card; the only
// differences from the plain version on the card are the orders of the two
// reductions (CoM, pair forces), which the stated tolerances absorb.
//
// The step loop itself (rollout_steps) lives in fused_rollout_common.cuh,
// which the reverse-mode segment kernel (fused_rollout_bwd.cu) shares.
//
// The fitness features (sources, needle, fall-over latch, NormDistByVol,
// speed windows, ballistic development; the JAX kernel's :912-946,
// :1001-1169, :1721-1837) compile into a second instance of each variant,
// launched when a feature bit or a source is on; their carry rides stats
// channels 22-46 and the window ring starts empty in every launch.
//
// Voxelyze's material, solver and boundary options (nonlinear and MDL_DATA
// stress, plasticity, the max-velocity clamp, equilibrium mode, BC regions)
// and the surface-compacted contact pass compile into a kernel of their own,
// fused_rollout_mat_kernel: the land variant's step with the third template
// parameter MAT, with and without the features (the JAX kernel's
// :372-404, :513-573, :907-910, :966-998, :1369-1371, :1519-1605, :734-774),
// launched when any of them is on: the MDL_DATA tables (B or 1, 2P + 3, V)
// and the BC channels (B or 1, 15, V) are read from device memory per voxel,
// the kinetic-energy ring rides stats channels 16-21 and the strain offset
// state channels 53-55. The host refuses them in water and with
// development. Bound as the land step: the stress-equalization loop adds
// 9 material-curve evaluations a bond (each a few loads of the point table
// with MDL_DATA), the ring one block reduction a step.
//
// Volume effects (B6d: the JAX kernel's :1178-1322 and _bond_dir's vol_ctx
// path :440-506, :577) compile into a kernel of their own,
// fused_rollout_vol_kernel: the material instance's step with VOL, with and
// without the features, so every other instance keeps its machine code.
// Per robot it takes a (9, V) scratch in device memory for the coupling's
// two neighbour exchanges (each bond's strain to the voxel pass, each
// voxel's transverse sums and sections back to the bond owners) and the
// stats row's dt as the carried dt (in: the first bond pass's, out: the
// last step's); the coupling carry rides state channels 47-52. Bound as
// the land step, with per step one block max (the dt), one more barrier
// (the voxel pass) and a pow for each free axis of a voxel; its block max
// reuses the reductions' shared scratch.
//
// Bodies past one block's shared memory run the device-memory instances of
// every kernel above (fused_rollout_gmem.cu), launched from this entry when
// the host hands it a buffer.
#include "fused_rollout_common.cuh"

template <int VARIANT, bool FEAT, bool DENSE>
__global__ void __launch_bounds__(MAX_THREADS)
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
        rollout_steps<VARIANT, true, false, false, DENSE>(st, 0, bo, a1, cu, n_knots,
                                                         knot_steps, step_base, X, Y, Z,
                                                         num_steps, p, flags, r, nullptr, sh,
                                                         scr, &fe, &fp);
        if (threadIdx.x == 0) store_feat(stat, fe, fp, flags);
    } else {
        rollout_steps<VARIANT, false, false, false, DENSE>(st, 0, bo, a1, cu, n_knots,
                                                          knot_steps, step_base, X, Y, Z,
                                                          num_steps, p, flags, r, nullptr, sh,
                                                          scr);
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

template <int VARIANT, bool FEAT>
static int launch_variant(float* state, const float* body, int body_batched,
                          float* stats, const float* a1, int a1_batched,
                          const float* ctrl, int n_knots, int knot_steps,
                          int step_base, int B, int X, int Y, int Z, int num_steps,
                          const Params& p, int flags, float* scratch,
                          const FeatParams& fp, cudaStream_t stream) {
    const int V = X * Y * Z;
    const int threads = V >= MAX_THREADS ? MAX_THREADS : ((V + 31) / 32) * 32;
    const size_t smem = k1_buffer_floats(V, (flags & F_COLL) != 0, 0) * sizeof(float);
    const auto kernel = k1_dense(flags, a1) ? fused_rollout_kernel<VARIANT, FEAT, true>
                                            : fused_rollout_kernel<VARIANT, FEAT, false>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<B, threads, smem, stream>>>(
        state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots,
        knot_steps, step_base, X, Y, Z, num_steps, p, flags, scratch, fp);
    return (int)cudaGetLastError();
}

// The material instance: the land variant with MAT, with and without the
// features. Beside the land kernel's inputs it takes the robot's MDL_DATA
// tables and BC channels (MatArgs), and its pair table may be the compact
// (S + 1, S) one. It and the volume kernel are built for one block an SM:
// ptxas then keeps the step in registers (179 without the features and
// contact, no spill) where its own target of 128 spilled 192 bytes:
// 164.6-164.7 against 172.7-174.4 ms on 1024 x 10^3 x 200 without contact
// (buildcmp, NVIDIA H100 80GB HBM3, 700 W).
template <bool FEAT, bool DENSE>
__global__ void __launch_bounds__(MAX_THREADS, 1)
fused_rollout_mat_kernel(float* state_all, const float* __restrict__ body_all,
                         int body_batched, float* stats_all,
                         const float* __restrict__ a1_all, int a1_batched,
                         const float* __restrict__ ctrl_all, int n_knots,
                         int knot_steps, int step_base, int X, int Y, int Z,
                         int num_steps, Params p, int flags, FeatParams fp, MatArgs ma,
                         int ss_batched, int bc_batched) {
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
    float ke[6];
    for (int k = 0; k < 6; ++k) ke[k] = stat[ST_KE + k];

    Robot r = load_robot(stat);
    if constexpr (FEAT) {
        Feat fe = load_feat(stat);
        rollout_steps<V_LAND, true, true, false, DENSE>(st, 0, bo, a1, cu, n_knots,
                                                        knot_steps, step_base, X, Y, Z,
                                                        num_steps, p, flags, r, nullptr, sh,
                                                        nullptr, &fe, &fp, &ma, ke);
        if (threadIdx.x == 0) store_feat(stat, fe, fp, flags);
    } else {
        rollout_steps<V_LAND, false, true, false, DENSE>(st, 0, bo, a1, cu, n_knots,
                                                         knot_steps, step_base, X, Y, Z,
                                                         num_steps, p, flags, r, nullptr, sh,
                                                         nullptr, nullptr, nullptr, &ma, ke);
    }

    if (threadIdx.x == 0) {
        if (flags & F_EQUIL)
            for (int k = 0; k < 6; ++k) stat[ST_KE + k] = ke[k];
        stat[ST_TIME] = r.t;
        stat[ST_DIV] = r.div ? 1.f : 0.f;
        stat[ST_INICM] = r.ini.x;
        stat[ST_INICM + 1] = r.ini.y;
        stat[ST_INICM + 2] = r.ini.z;
        stat[ST_CAPT] = r.capt ? 1.f : 0.f;
    }
}

template <bool FEAT>
static int launch_mat(float* state, const float* body, int body_batched, float* stats,
                      const float* a1, int a1_batched, const float* ctrl, int n_knots,
                      int knot_steps, int step_base, int B, int X, int Y, int Z,
                      int num_steps, const Params& p, int flags, const FeatParams& fp,
                      const MatArgs& ma, int ss_batched, int bc_batched,
                      cudaStream_t stream) {
    const int V = X * Y * Z;
    const int threads = V >= MAX_THREADS ? MAX_THREADS : ((V + 31) / 32) * 32;
    // the compact contact pass stages the S surface voxels in place of V
    const size_t smem = k1_buffer_floats(V, (flags & F_COLL) != 0, ma.n_surf) * sizeof(float);
    const auto kernel = k1_dense(flags, a1) ? fused_rollout_mat_kernel<FEAT, true>
                                            : fused_rollout_mat_kernel<FEAT, false>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<B, threads, smem, stream>>>(
        state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots, knot_steps,
        step_base, X, Y, Z, num_steps, p, flags, fp, ma, ss_batched, bc_batched);
    return (int)cudaGetLastError();
}

// The material instance's kernel with VOL. Beside its inputs it takes the
// volume constants and the (B, 9, V) scratch (VolArgs), and it writes the
// last step's dt to the stats row.
template <bool FEAT, bool DENSE>
__global__ void __launch_bounds__(MAX_THREADS, 1)
fused_rollout_vol_kernel(float* state_all, const float* __restrict__ body_all,
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
    va.scr += (size_t)b * VOL_SCR * V;
    float ke[6];
    for (int k = 0; k < 6; ++k) ke[k] = stat[ST_KE + k];

    Robot r = load_robot(stat);
    if constexpr (FEAT) {
        Feat fe = load_feat(stat);
        rollout_steps<V_LAND, true, true, true, DENSE>(st, 0, bo, a1, cu, n_knots,
                                                       knot_steps, step_base, X, Y, Z,
                                                       num_steps, p, flags, r, nullptr, sh,
                                                       nullptr, &fe, &fp, &ma, ke, &va);
        if (threadIdx.x == 0) store_feat(stat, fe, fp, flags);
    } else {
        rollout_steps<V_LAND, false, true, true, DENSE>(st, 0, bo, a1, cu, n_knots,
                                                        knot_steps, step_base, X, Y, Z,
                                                        num_steps, p, flags, r, nullptr, sh,
                                                        nullptr, nullptr, nullptr, &ma, ke,
                                                        &va);
    }

    if (threadIdx.x == 0) {
        if (flags & F_EQUIL)
            for (int k = 0; k < 6; ++k) stat[ST_KE + k] = ke[k];
        stat[ST_TIME] = r.t;
        stat[ST_DIV] = r.div ? 1.f : 0.f;
        stat[ST_DT] = r.dt;
        stat[ST_INICM] = r.ini.x;
        stat[ST_INICM + 1] = r.ini.y;
        stat[ST_INICM + 2] = r.ini.z;
        stat[ST_CAPT] = r.capt ? 1.f : 0.f;
    }
}

template <bool FEAT>
static int launch_vol(float* state, const float* body, int body_batched, float* stats,
                      const float* a1, int a1_batched, const float* ctrl, int n_knots,
                      int knot_steps, int step_base, int B, int X, int Y, int Z,
                      int num_steps, const Params& p, int flags, const FeatParams& fp,
                      const MatArgs& ma, int ss_batched, int bc_batched, const VolArgs& va,
                      cudaStream_t stream) {
    const int V = X * Y * Z;
    const int threads = V >= MAX_THREADS ? MAX_THREADS : ((V + 31) / 32) * 32;
    const size_t smem = k1_buffer_floats(V, (flags & F_COLL) != 0, ma.n_surf) * sizeof(float);
    const auto kernel = k1_dense(flags, a1) ? fused_rollout_vol_kernel<FEAT, true>
                                            : fused_rollout_vol_kernel<FEAT, false>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<B, threads, smem, stream>>>(
        state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots, knot_steps,
        step_base, X, Y, Z, num_steps, p, flags, fp, ma, ss_batched, bc_batched, va);
    return (int)cudaGetLastError();
}

// launches the device-memory instance the flags select (fused_rollout_gmem.cu,
// a translation unit of its own in the same library)
int launch_gmem(float* state, const float* body, int body_batched, float* stats,
                const float* a1, int a1_batched, const float* ctrl, int n_knots, int knot_steps,
                int step_base, int B, int X, int Y, int Z, int num_steps, const Params& p,
                int flags, float* scratch, const FeatParams& fp, bool feat, const MatArgs* ma,
                int ss_batched, int bc_batched, const VolArgs* va, float* gbuf, int gstride,
                cudaStream_t st);

// scratch: (B, 6, V) floats of device memory, needed by the facet-drag
// variant alone (flags F_FLUID | F_FLUID_MESH), else null. fparams: the
// features' N_FEAT_PARAMS constants (ops/fused_rollout.py _feat_params).
// The material instance's inputs: ss, the MDL_DATA tables (B or 1, 2P + 3,
// V) with n_pts = P, or null; bc, the BC channels (B or 1, 15, V), or null;
// n_surf, the surface count of a compact pair table (S + 1, S), or 0;
// mparams, its float constants (ops/fused_rollout.py _mat_params).
// The volume instance's inputs: vscratch, (B, 9, V) floats of device
// memory, and vparams (ops/fused_rollout.py _vol_params); null without the
// volume bit. gbuf: null for the shared-memory instances; else the
// device-memory instances run, robot b's bond buffer at gbuf + b * gstride.
extern "C" int fused_rollout(float* state, const float* body, int body_batched,
                             float* stats, const float* a1, int a1_batched,
                             const float* ctrl, int n_knots, int knot_steps,
                             int step_base, int B, int X, int Y, int Z,
                             int num_steps, const float* params, int flags,
                             float* scratch, const float* fparams, const float* ss,
                             int ss_batched, int n_pts, const float* bc, int bc_batched,
                             int n_surf, const float* mparams, float* vscratch,
                             const float* vparams, float* gbuf, int gstride, void* stream) {
    Params p;
    memcpy(&p, params, sizeof(float) * N_PARAMS);
    const FeatParams fp = feat_params_from(fparams);
    const int variant = variant_of(flags);
    if (variant == V_FLUID_MESH && scratch == nullptr) return (int)cudaErrorInvalidValue;
    // the ballistic rebase lives in the development variant
    if ((flags & F_BALLISTIC) && variant != V_DEVO) return (int)cudaErrorInvalidValue;
    if (fp.n_src < 0 || fp.n_src > MAX_SRC || fp.n_win < 0 || fp.n_win > MAX_WIN)
        return (int)cudaErrorInvalidValue;
    const bool feat = (flags & F_FEAT) || fp.n_src > 0;
    const bool mat = (flags & (F_MAT | F_VOL)) != 0;
    // the material and volume instances are the land variant's, and need
    // their tables
    if (mat && (variant != V_LAND || ((flags & F_MDL) && (ss == nullptr || n_pts < 2)) ||
                ((flags & F_BC) && bc == nullptr) ||
                ((flags & F_COMPACT) && (!(flags & F_COLL) || n_surf <= 0))))
        return (int)cudaErrorInvalidValue;
    const MatArgs ma = {nullptr, (flags & F_MDL) ? ss : nullptr, (flags & F_BC) ? bc : nullptr,
                        n_pts, (flags & F_COMPACT) ? n_surf : 0, mparams[0]};
    if ((flags & F_VOL) && (vscratch == nullptr || vparams == nullptr))
        return (int)cudaErrorInvalidValue;
    if (gbuf) {
        const VolArgs va = (flags & F_VOL) ? VolArgs{vscratch, vparams[0], vparams[1], vparams[2]}
                                           : VolArgs{nullptr, 0.f, 0.f, 0.f};
        return launch_gmem(state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots,
                           knot_steps, step_base, B, X, Y, Z, num_steps, p, flags, scratch, fp,
                           feat, mat ? &ma : nullptr, ss_batched, bc_batched,
                           (flags & F_VOL) ? &va : nullptr, gbuf, gstride,
                           (cudaStream_t)stream);
    }
    if (flags & F_VOL) {
        const VolArgs va = {vscratch, vparams[0], vparams[1], vparams[2]};
        return feat ? launch_vol<true>(state, body, body_batched, stats, a1, a1_batched, ctrl,
                                       n_knots, knot_steps, step_base, B, X, Y, Z, num_steps,
                                       p, flags, fp, ma, ss_batched, bc_batched, va,
                                       (cudaStream_t)stream)
                    : launch_vol<false>(state, body, body_batched, stats, a1, a1_batched,
                                        ctrl, n_knots, knot_steps, step_base, B, X, Y, Z,
                                        num_steps, p, flags, fp, ma, ss_batched, bc_batched,
                                        va, (cudaStream_t)stream);
    }
    if (mat) {
        return feat ? launch_mat<true>(state, body, body_batched, stats, a1, a1_batched, ctrl,
                                       n_knots, knot_steps, step_base, B, X, Y, Z, num_steps,
                                       p, flags, fp, ma, ss_batched, bc_batched,
                                       (cudaStream_t)stream)
                    : launch_mat<false>(state, body, body_batched, stats, a1, a1_batched,
                                        ctrl, n_knots, knot_steps, step_base, B, X, Y, Z,
                                        num_steps, p, flags, fp, ma, ss_batched, bc_batched,
                                        (cudaStream_t)stream);
    }
#define LAUNCH(VARIANT)                                                                   \
    (feat ? launch_variant<VARIANT, true>(state, body, body_batched, stats, a1, a1_batched, \
                                          ctrl, n_knots, knot_steps, step_base, B, X, Y, Z,  \
                                          num_steps, p, flags, scratch, fp,                  \
                                          (cudaStream_t)stream)                              \
          : launch_variant<VARIANT, false>(state, body, body_batched, stats, a1,             \
                                           a1_batched, ctrl, n_knots, knot_steps, step_base, \
                                           B, X, Y, Z, num_steps, p, flags, scratch, fp,     \
                                           (cudaStream_t)stream))
    switch (variant) {
        case V_FLUID_FACE: return LAUNCH(V_FLUID_FACE);
        case V_FLUID_MESH: return LAUNCH(V_FLUID_MESH);
        case V_DEVO: return LAUNCH(V_DEVO);
        default: return LAUNCH(V_LAND);
    }
#undef LAUNCH
}

