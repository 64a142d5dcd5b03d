// Host stand-ins for the CUDA built-ins the kernels use: one thread a block.
#pragma once
#include <cmath>
#include <cstddef>
#include <cstring>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
struct EmuDim3 { unsigned x, y, z; };
static EmuDim3 threadIdx = {0, 0, 0}, blockDim = {1, 1, 1}, blockIdx = {0, 0, 0};
inline void __syncthreads() {}
inline float __shfl_xor_sync(unsigned, float, int) { return 0.f; }
inline int atomicOr(int* a, int v) { int o = *a; *a |= v; return o; }
inline unsigned atomicOr(unsigned* a, unsigned v) { unsigned o = *a; *a |= v; return o; }
inline unsigned atomicAdd(unsigned* a, unsigned v) { unsigned o = *a; *a += v; return o; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float __ldg(const float* p) { return *p; }
inline float4 __ldg(const float4* p) { return *p; }
inline float rsqrtf(float x) { return 1.f / sqrtf(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int min(int a, int b) { return a < b ? a : b; }
// The warp-wide steps of ops/csrc/pair_contact.cuh, where one thread stands
// for a warp: f is evaluated for each of the 32 lanes and combined as the
// card combines it (a ballot's bits; the xor butterfly, lane 0's value)
template <class P>
inline unsigned warp_ballot(P pred) {
    unsigned bits = 0u;
    for (int l = 0; l < 32; ++l)
        if (pred(l)) bits |= 1u << l;
    return bits;
}
template <class T, class F, class Op>
inline T warp_fold(F f, Op op) {
    T v[32], w[32];
    for (int l = 0; l < 32; ++l) v[l] = f(l);
    for (int o = 16; o > 0; o >>= 1) {
        for (int l = 0; l < 32; ++l) w[l] = op(v[l], v[l ^ o]);
        memcpy(v, w, sizeof(v));
    }
    return v[0];
}
template <int U, class L>
inline void warp_nonzero(unsigned (&bits)[U], L load) {
    for (int k = 0; k < U; ++k) bits[k] = 0u;
    for (int l = 0; l < 32; ++l)
        for (int k = 0; k < U; ++k)
            if (load(l, k) != 0.f) bits[k] |= 1u << l;
}
// Thread-block clusters: a cluster of one block. B4 (ops/csrc/
// fused_rollout_bwd.cuh) runs a robot's C blocks in turn itself, one pass
// at a time, their slabs in one array, so these are never asked for more.
namespace cooperative_groups {
struct cluster_group {
    void sync() const {}
    template <class T>
    T* map_shared_rank(T* p, unsigned) const { return p; }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
