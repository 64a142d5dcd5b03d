// B5: the surface-compacted contact pass, its own launch.
//
// Replaces: evosoro_tpu/ops/fused_rollout.py, _pair_contact_forces_compact
// (the TPU kernel evaluates it inside _make_kernel's step, as K1's compact
// instances do here; this launch exists so the pass can be held against its
// plain version and the dense pass on its own, and so its tile counts can
// be read).
//
// Bound on this card: the compact table's bytes (read once) and ~20
// operations a tested pair (roofline.py b5_work). Design: a block a robot
// runs the pass as K1's step does (pair_contact.cuh over the S surface
// voxels): it reads the robot's (S, S) rows into the tile mask and active
// bits, stages the S entries through the index row with the groups' boxes,
// and each warp owns its row groups, a lane a row, so a row sums in the
// order K1's does. Voxels off the surface receive -0. A translation unit
// of its own in the pair_contact library, so K2's kernels keep their
// machine code. FMA contraction is off (-fmad=false).
#include <cuda_runtime.h>

#include "pair_contact.cuh"

#define B5_THREADS 512

// One robot's pass as K1's step runs it, by the whole block: pos (3, V),
// scale (V), table (S + 1, S) of the compact pass (COMPACT), else the
// V x V dense table; sh: pair_stage_floats + pair_aux_floats of the
// entries; out (3, V); slack: 1 + the cull's margin; counts: null or the
// three tile counts (pair_hot_word), added to. The host build
// (tests/cuda_host) runs both tables.
template <bool COMPACT>
__device__ inline void pair_pass_alone(const float* pos, const float* scale, const float* table,
                                       int V, int S, float* sh, float* out, float slack,
                                       unsigned* counts, int nwarps) {
    const int N = COMPACT ? S : V;
    const float* a1 = COMPACT ? table + S : table;
    float* sp = sh;
    float* aux = sp + pair_stage_floats(N);
    unsigned* tables = pair_mask(aux, pair_groups(N));
    for (int k = threadIdx.x; k < pair_table_words(N); k += blockDim.x) tables[k] = 0u;
    if (COMPACT)
        for (int k = threadIdx.x; k < 3 * V; k += blockDim.x) out[k] = -0.f;
    __syncthreads();
    pair_tile_mask(a1, N, tables, 0, N);
    __syncthreads();
    pair_stage<COMPACT>(pos, pos + V, pos + 2 * V, scale, N, sp, aux, table);
    __syncthreads();
    pair_contact_block<COMPACT>(sp, a1, N, aux, out, V, 0, pair_groups(N), nullptr, slack,
                                counts, nwarps, table);
}

#ifndef EVOSORO_HOST_EMULATION
// pos (B, 3, V), scale (B, V), table (B or 1, S + 1, S), out (B, 3, V):
// robot blockIdx.x
__global__ void __launch_bounds__(B5_THREADS)
pair_contact_compact_kernel(const float* __restrict__ pos, const float* __restrict__ scale,
                            const float* __restrict__ table, float* __restrict__ out, int V,
                            int S, int table_batched, float slack, unsigned* counts) {
    extern __shared__ float sh[];
    const int b = blockIdx.x;
    pair_pass_alone<true>(pos + (size_t)b * 3 * V, scale + (size_t)b * V,
                          table + (table_batched ? (size_t)b * (S + 1) * S : 0), V, S, sh,
                          out + (size_t)b * 3 * V, slack, counts, B5_THREADS / 32);
}

// counts: null, or 3 words that receive the tile counts
extern "C" int pair_contact_forces_compact(const float* pos, const float* scale,
                                           const float* table, float* out, int B, int V, int S,
                                           int table_batched, float margin, unsigned* counts,
                                           void* stream) {
    const size_t smem = ((size_t)pair_stage_floats(S) + pair_aux_floats(S)) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pair_contact_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    pair_contact_compact_kernel<<<B, B5_THREADS, smem, (cudaStream_t)stream>>>(
        pos, scale, table, out, V, S, table_batched, 1.f + margin, counts);
    return (int)cudaGetLastError();
}
#endif
