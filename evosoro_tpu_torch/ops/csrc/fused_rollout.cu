// K1: fused forward rollout, B robots x num_steps in one launch.
//
// Replaces: evosoro_tpu/ops/fused_rollout.py, _make_kernel (forward branch)
// as launched by _fused_call, restricted to the evolution loop's envelope:
// linear materials, floor with Coulomb friction and the sticky floor,
// gravity, thermal actuation with the mid-life freeze, and self-collision
// through the dense pair pass of pair_contact.cuh (K2). The host wrapper
// refuses every other feature flag. It also carries that kernel's MPC
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
// scales are staged in shared memory and the pair pass writes its forces
// there too (7 more floats a voxel). After a barrier, phase B sums the
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
// collision on, the pair pass (pair_contact.cuh) walks each table row with
// one dependent load a lane per iteration and dominates the step. Shared
// memory caps V at ~1600 voxels (~1350 with collision). Keeping the state
// resident on chip across steps and more warps per SM are the levers.
//
// Numerics: built with -fmad=false and without fast math, so every multiply
// and add rounds as in PyTorch's eager ops and sinf/acosf/sqrtf/division
// are the same IEEE-accurate functions torch uses on the card; the only
// differences from the plain version on the card are the orders of the two
// reductions (CoM, pair forces), which the stated tolerances absorb.
//
// The step loop itself (rollout_steps) lives in fused_rollout_common.cuh,
// which the reverse-mode segment kernel (fused_rollout_bwd.cu) shares.
#include "fused_rollout_common.cuh"

__global__ void __launch_bounds__(MAX_THREADS)
fused_rollout_kernel(float* state_all, const float* __restrict__ body_all,
                     int body_batched, float* stats_all,
                     const float* __restrict__ a1_all, int a1_batched,
                     const float* __restrict__ ctrl_all, int n_knots,
                     int knot_steps, int step_base, int X, int Y, int Z,
                     int num_steps, Params p, int flags) {
    extern __shared__ float sh[];
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    float* st = state_all + (size_t)b * C_S * V;
    const float* bo = body_all + (body_batched ? (size_t)b * C_B * V : 0);
    float* stat = stats_all + (size_t)b * C_STAT;
    const float* a1 = a1_all ? a1_all + (a1_batched ? (size_t)b * V * V : 0) : nullptr;
    const float* cu = n_knots > 0 ? ctrl_all + (size_t)b * n_knots * V : nullptr;

    Robot r = load_robot(stat);
    rollout_steps(st, 0, bo, a1, cu, n_knots, knot_steps, step_base, X, Y, Z,
                  num_steps, p, flags, r, nullptr, sh);

    if (threadIdx.x == 0) {
        stat[ST_TIME] = r.t;
        stat[ST_DIV] = r.div ? 1.f : 0.f;
        stat[ST_INICM] = r.ini.x;
        stat[ST_INICM + 1] = r.ini.y;
        stat[ST_INICM + 2] = r.ini.z;
        stat[ST_CAPT] = r.capt ? 1.f : 0.f;
    }
}

extern "C" int fused_rollout(float* state, const float* body, int body_batched,
                             float* stats, const float* a1, int a1_batched,
                             const float* ctrl, int n_knots, int knot_steps,
                             int step_base, int B, int X, int Y, int Z,
                             int num_steps, const float* params, int flags,
                             void* stream) {
    Params p;
    memcpy(&p, params, sizeof(float) * N_PARAMS);
    const int V = X * Y * Z;
    const int threads = V >= MAX_THREADS ? MAX_THREADS : ((V + 31) / 32) * 32;
    const size_t smem = (size_t)(BF + ((flags & F_COLL) ? 7 : 0)) * V * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            fused_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    fused_rollout_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots,
        knot_steps, step_base, X, Y, Z, num_steps, p, flags);
    return (int)cudaGetLastError();
}
