// fma_peak: FP32 multiply-add micro-kernel, the yardstick of the roofline.
//
// Replaces: tools/roofline.py, measure_vpu_peak (a Pallas kernel of 16
// independent multiply-add chains on a tile resident in VMEM). The same
// function here: out[i] = sum over k < 16 of chain_k, where chain_k starts
// at x[i] * (1 + 1e-7 k) and takes `iters` steps of acc = acc * a + b.
//
// Bound on this card: operations, by construction. Each thread keeps its 16
// accumulators in registers and touches device memory twice (one load, one
// store), so 2 * 16 * iters flops stand against 8 bytes a thread. Sixteen
// independent chains cover the 4-cycle latency of the FP32 pipe with room to
// spare, and a grid of many waves of 256-thread blocks keeps every SM's
// four schedulers issuing. The other kernels of this package are built with
// -fmad=false; this one must issue fused multiply-adds whatever the flags,
// so it names the instruction (__fmaf_rn). a and b are kernel arguments, so
// the compiler cannot fold the chains.
#include <cuda_runtime.h>

#define CHAINS 16

__global__ void __launch_bounds__(256)
fma_peak_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                int iters, float a, float b) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float x0 = x[i];
    float acc[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc[k] = x0 * (1.0f + 1e-7f * (float)k);
#pragma unroll 8
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) acc[k] = __fmaf_rn(acc[k], a, b);
    }
    float s = acc[0];
#pragma unroll
    for (int k = 1; k < CHAINS; ++k) s = s + acc[k];
    out[i] = s;
}

extern "C" int fma_peak(const float* x, float* out, int n, int iters,
                        float a, float b, void* stream) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    fma_peak_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        x, out, n, iters, a, b);
    return (int)cudaGetLastError();
}
