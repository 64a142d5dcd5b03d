// K2: dense pair contact, its own launch.
//
// Replaces: evosoro_tpu/ops/fused_rollout.py, _pair_contact_forces (the
// TPU kernel evaluates it inside _make_kernel's step; this launch exists so
// the routine can be held against its plain version on its own, and so its
// tile counts can be read).
//
// Bound on this card: the table's bytes (read once) and ~20 operations a
// tested pair (roofline.py k2_work). Design: the routine of pair_contact.cuh
// in two launches, so a small batch still puts many warps in flight over
// the card's 132 SMs. pair_mask_kernel, a block for each table and row
// group, reads the group's 32 rows into the table's tile mask and active
// bits in device memory (the wrapper zeroes them; blocks of one table OR
// their column bits into the same words, so the active bits are those of
// the whole table, as K1's). pair_contact_kernel, a block for each robot
// and K2_GROUPS row groups, copies them into shared memory, stages all V
// positions and scales with the boxes, and runs the pass over its groups
// with each group's hot tiles split over 4 (or 8) warps, whose partial sums
// it adds in warp order. Its tile counts are those K1 meets in a step from
// the same state. The sums run in another order than torch.sum, which the
// max-|force|-relative tolerance of the comparison absorbs. FMA contraction
// is off (-fmad=false).
#include <cuda_runtime.h>

#include "pair_contact.cuh"

#define K2_THREADS 256
#define K2_GROUPS 2

// a1 (T, V, V); tables (T, pair_table_words(V)), zeroed: table blockIdx.x,
// the rows of row group blockIdx.y
__global__ void __launch_bounds__(K2_THREADS)
pair_mask_kernel(const float* __restrict__ a1, int V, unsigned* tables) {
    const int t = blockIdx.x;
    const int r0 = 32 * blockIdx.y;
    pair_tile_mask(a1 + (size_t)t * V * V, V, tables + (size_t)t * pair_table_words(V), r0,
                   r0 + 32 < V ? r0 + 32 : V);
}

// pos (B, 3, V), scale (B, V), a1 (B or 1, V, V) with its tables from
// pair_mask_kernel, out (B, 3, V); counts: null, or 3 words that receive
// the tile counts (pair_hot_word)
__global__ void __launch_bounds__(K2_THREADS)
pair_contact_kernel(const float* __restrict__ pos, const float* __restrict__ scale,
                    const float* __restrict__ a1, float* __restrict__ out, int V,
                    int a1_batched, const unsigned* __restrict__ tables, float slack,
                    unsigned* counts) {
    extern __shared__ float sh[];
    float* sp = sh;
    float* aux = sp + pair_stage_floats(V);
    float* partial = aux + pair_aux_floats(V);
    const int G = pair_groups(V);
    const int b = blockIdx.x;
    const int g0 = blockIdx.y * K2_GROUPS;
    const int g1 = g0 + K2_GROUPS < G ? g0 + K2_GROUPS : G;
    const int n = pair_table_words(V);
    const unsigned* tb = tables + (a1_batched ? (size_t)b * n : 0);
    for (int k = threadIdx.x; k < n; k += blockDim.x) pair_mask(aux, G)[k] = tb[k];
    __syncthreads();
    const float* p = pos + (size_t)b * 3 * V;
    pair_stage(p, p + V, p + 2 * V, scale + (size_t)b * V, V, sp, aux);
    __syncthreads();
    pair_contact_block(sp, a1 + (a1_batched ? (size_t)b * V * V : 0), V, aux,
                       out + (size_t)b * 3 * V, V, g0, g1, partial, slack, counts,
                       K2_THREADS / 32);
}

// shared bytes of a pass block (ops/fused_rollout.py _k2_smem_bytes)
static size_t k2_smem(int V) {
    return ((size_t)pair_stage_floats(V) + pair_aux_floats(V) + (K2_THREADS / 32) * 96) *
           sizeof(float);
}

// tables: (B or 1, pair_table_words(V)) words of device memory, zeroed
extern "C" int pair_contact_forces(const float* pos, const float* scale, const float* a1,
                                   float* out, int B, int V, int a1_batched, float margin,
                                   unsigned* tables, unsigned* counts, void* stream) {
    const int G = pair_groups(V);
    pair_mask_kernel<<<dim3(a1_batched ? B : 1, G), K2_THREADS, 0, (cudaStream_t)stream>>>(
        a1, V, tables);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const size_t smem = k2_smem(V);
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(pair_contact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    pair_contact_kernel<<<dim3(B, (G + K2_GROUPS - 1) / K2_GROUPS), K2_THREADS, smem,
                          (cudaStream_t)stream>>>(pos, scale, a1, out, V, a1_batched, tables,
                                                  1.f + margin, counts);
    return (int)cudaGetLastError();
}
