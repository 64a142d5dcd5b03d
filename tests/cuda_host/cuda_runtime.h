// Host stand-ins for the CUDA built-ins the kernels use: one thread a block.
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(x)
struct EmuDim3 { unsigned x, y, z; };
static EmuDim3 threadIdx = {0, 0, 0}, blockDim = {1, 1, 1}, blockIdx = {0, 0, 0};
inline void __syncthreads() {}
inline float __shfl_xor_sync(unsigned, float, int) { return 0.f; }
inline int atomicOr(int* a, int v) { int o = *a; *a |= v; return o; }
inline float __ldg(const float* p) { return *p; }
inline float rsqrtf(float x) { return 1.f / sqrtf(x); }
