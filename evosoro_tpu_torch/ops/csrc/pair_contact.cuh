// Dense pair contact for one robot: the device routine shared by K2's own
// launch (pair_contact.cu) and by the fused rollout kernel (fused_rollout.cu).
//
// Replaces: evosoro_tpu/ops/fused_rollout.py, _pair_contact_forces.
// The force on voxel i is
//   f_i = -sum_j a1_ij * (nom * rsqrt(d2) - 1) * (p_j - p_i)
// wherever nom * rsqrt(d2) > 1, with nom = 0.75 (s_i + s_j). Zeros in the
// dense a1 table exclude lattice-near pairs, non-surface voxels and padding.
//
// Design: the whole block works on one robot. Positions and scales are
// staged in shared memory by the caller; each warp takes a row i of the
// table and its 32 lanes walk j along that row, so the a1 reads from device
// memory are coalesced and follow the table's own [i, j] order. Pairs with
// a1 == 0 are skipped (they contribute exactly 0 in the plain version). A
// warp shuffle reduces the three sums and lane 0 writes -sum.
//
// The surface-compacted pass (pair_contact_compact_block) replaces
// _pair_contact_forces_compact: the same field over the S surface voxels
// only, an (S, S) table in place of (V, V). On the TPU the gather and the
// scatter are one-hot matrix products; here the caller stages the S entries
// through the table's index row (an indexed load each) and each warp's lane
// 0 writes its row's force to the owning voxel (the indices are distinct,
// so nothing collides).
#pragma once

// A warp walks a row, 32 lanes along it; the host build (tests/cuda_host)
// runs one thread a block, which walks every row and every column itself.
#ifdef EVOSORO_HOST_EMULATION
#define PAIR_LANE 0
#define PAIR_WARP 0
#define PAIR_NWARPS 1
#define PAIR_LANES 1
#else
#define PAIR_LANE (threadIdx.x & 31)
#define PAIR_WARP (threadIdx.x >> 5)
#define PAIR_NWARPS (blockDim.x >> 5)
#define PAIR_LANES 32
#endif

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// sp: shared [4*V] = x[V], y[V], z[V], s[V]; a1: this robot's V x V table,
// row-major; out[c * out_stride + i] receives force component c on voxel i,
// for the rows i in [row0, row1).
__device__ inline void pair_contact_block(const float* sp,
                                          const float* __restrict__ a1, int V,
                                          float* out, int out_stride,
                                          int row0, int row1) {
    const int lane = PAIR_LANE;
    const int warp = PAIR_WARP;
    const int nwarps = PAIR_NWARPS;
    const float* px = sp;
    const float* py = sp + V;
    const float* pz = sp + 2 * V;
    const float* ps = sp + 3 * V;
    for (int i = row0 + warp; i < row1; i += nwarps) {
        const float xi = px[i], yi = py[i], zi = pz[i], si = ps[i];
        const float* row = a1 + (size_t)i * V;
        float fx = 0.f, fy = 0.f, fz = 0.f;
        for (int j = lane; j < V; j += PAIR_LANES) {
            const float a = row[j];
            if (a == 0.f) continue;
            const float dx = px[j] - xi;
            const float dy = py[j] - yi;
            const float dz = pz[j] - zi;
            const float d2 = dx * dx + dy * dy + dz * dz;
            // rsqrtf, as torch.rsqrt on the card and lax.rsqrt in the TPU kernel
            const float inv = rsqrtf(fmaxf(d2, 1e-30f));
            const float tt = (0.75f * (si + ps[j])) * inv;
            if (tt > 1.f) {
                const float mag = a * (tt - 1.f);
                fx += mag * dx;
                fy += mag * dy;
                fz += mag * dz;
            }
        }
        fx = warp_sum(fx);
        fy = warp_sum(fy);
        fz = warp_sum(fz);
        if (lane == 0) {
            out[i] = -fx;
            out[out_stride + i] = -fy;
            out[2 * out_stride + i] = -fz;
        }
    }
}

// sp: shared [4*S] = x[S], y[S], z[S], s[S] of the surface voxels; a1s: the
// robot's S x S compact table, row-major; idx: its index row (S voxel
// indices as floats); out[c * out_stride + idx[i]] receives force
// component c on surface voxel i.
__device__ inline void pair_contact_compact_block(const float* sp,
                                                  const float* __restrict__ a1s,
                                                  const float* __restrict__ idx, int S,
                                                  float* out, int out_stride) {
    const int lane = PAIR_LANE;
    const int warp = PAIR_WARP;
    const int nwarps = PAIR_NWARPS;
    const float* px = sp;
    const float* py = sp + S;
    const float* pz = sp + 2 * S;
    const float* ps = sp + 3 * S;
    for (int i = warp; i < S; i += nwarps) {
        const float xi = px[i], yi = py[i], zi = pz[i], si = ps[i];
        const float* row = a1s + (size_t)i * S;
        float fx = 0.f, fy = 0.f, fz = 0.f;
        for (int j = lane; j < S; j += PAIR_LANES) {
            const float a = row[j];
            if (a == 0.f) continue;
            const float dx = px[j] - xi;
            const float dy = py[j] - yi;
            const float dz = pz[j] - zi;
            const float d2 = dx * dx + dy * dy + dz * dz;
            const float inv = rsqrtf(fmaxf(d2, 1e-30f));
            const float tt = (0.75f * (si + ps[j])) * inv;
            if (tt > 1.f) {
                const float mag = a * (tt - 1.f);
                fx += mag * dx;
                fy += mag * dy;
                fz += mag * dz;
            }
        }
        fx = warp_sum(fx);
        fy = warp_sum(fy);
        fz = warp_sum(fz);
        if (lane == 0) {
            const int u = (int)idx[i];
            out[u] = -fx;
            out[out_stride + u] = -fy;
            out[2 * out_stride + u] = -fz;
        }
    }
}
