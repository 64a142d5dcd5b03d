// Pair contact for one robot: the device routine shared by K2's own launch
// (pair_contact.cu), by every K1 kernel that runs dense contact
// (fused_rollout.cu) and by their device-memory twins (fused_rollout_gmem.cu),
// and over the surface voxels alone by K1's compact instances and the
// compact pass's own launch (pair_contact_compact.cu).
//
// Replaces: evosoro_tpu/ops/fused_rollout.py, _pair_contact_forces (and
// _pair_contact_forces_compact, at the end of this note). The
// force on voxel i is
//   f_i = -sum_j a1_ij * (nom * rsqrt(d2) - 1) * (p_j - p_i)
// wherever nom * rsqrt(d2) > 1, with nom = 0.75 (s_i + s_j). Zeros in the
// dense a1 table exclude lattice-near pairs, non-surface voxels and padding.
// Every pair the routine evaluates runs the plain version's arithmetic (the
// difference, d2, rsqrtf(fmaxf(d2, 1e-30f)), tt = 0.75 (s_i + s_j) inv,
// the gate tt > 1 and a1 (tt - 1) d, built with -fmad=false) on the same a1
// floats; only the order in which a row's terms are summed is its own.
//
// Bound on this card: the table's bytes once a launch and ~20 operations a
// tested pair (roofline.py). A step of the old row walk (a warp a row, one
// dependent load of a1 a lane and iteration, every entry of the V x V table
// every step) was latency-bound at a few percent of that. The design cuts
// the work a step and keeps the loads in flight, in 32 x 32 tiles of the
// table (row group g, column group h: voxels 32 g .. 32 g + 31 in flat
// x-major order):
//
// 1. Static tile mask, once a launch (pair_tile_mask). The block reads its
//    rows of the table once, with coalesced loads, and keeps a bit for each
//    tile that holds a nonzero entry, and a bit for each voxel whose row or
//    column holds one ("active"). Interior rows, empty cells and lattice-near
//    blocks cost nothing for the rest of the launch.
// 2. Dynamic cull, every step (pair_stage, pair_tile_near). Staging the
//    positions and scales (one float4 a voxel, padded with zeros to whole
//    groups) also takes each group's box over its active voxels (min and max
//    of x, y, z) and their largest scale. Tile (g, h) is evaluated only if
//    gap2 < R * R, gap2 = gx*gx + gy*gy + gz*gz with gx = max(lo_h.x -
//    hi_g.x, lo_g.x - hi_h.x, 0) (likewise y, z) and R = 0.75 (smax_g +
//    smax_h) (1 + margin). Why a skipped pair contributes exactly 0:
//    a pair (i, j) with a1_ij != 0 has i active in g and j active in h, so
//    x_j - x_i >= lo_h.x - hi_g.x in real numbers; rounding is monotone, so
//    the kernel's |dx| = |fl(x_j - x_i)| >= gx as the cull computes it, and
//    its d2, summed in the same order, is >= gap2 >= fl(R * R). Likewise its
//    nom <= N = fl(0.75 fl(smax_g + smax_h)). With u = 2^-24 and rsqrtf
//    within 2 ulp: tt <= N d2^-1/2 (1 + 2^-22)(1 + u) and fl(R * R) >= N^2
//    (1 + margin)^2 (1 - u)^3, so tt <= (1 + 4e-7) / (1 + margin) < 1 for
//    any margin above 1e-6, and the plain version's where() gives exactly
//    0. The margin has one source, ops/fused_rollout.py PAIR_CULL_MARGIN
//    (1e-3): K1 takes 1 + margin as Params::pair_slack, K2 the margin as
//    an argument. A negative margin drops touching pairs: the guards of
//    tests/test_torch_pair_host.py and chip_smoke.py.
// 3. Row owners, loads issued ahead (pair_contact_block). A warp takes a
//    row group; each lane owns one row and walks the group's hot tiles in
//    ascending order. For a tile it reads its row's 32 entries as 128
//    contiguous bytes in independent loads (8 float4 where V is a multiple
//    of 4 and the table 16-byte aligned, else 32 floats), issues the next
//    hot tile's loads before the current tile's arithmetic, and reads the
//    column group's positions as shared broadcasts. A row sums ascending by
//    tile, then column: no shuffle tree, and the same bits from run to run.
//    Row groups go round-robin over the block's warps. Where a launch gives
//    a block fewer row groups than half its warps (K2), each group's hot
//    tiles are dealt to `split` warps in turn and their partial sums are
//    added in warp order after a barrier.
//
// Memory (pair_stage_floats, pair_aux_floats): 128 floats a group of staged
// float4s, and beside them 8 floats a group of box, the tile mask (a 32-bit
// word for each 32 column groups of a row group) and a word of active bits
// a group; K1 charges them to its buffer (ops/fused_rollout.py
// k1_buffer_floats).
//
// The surface-compacted pass replaces _pair_contact_forces_compact: the same
// field over the S surface voxels only, an (S, S) table in place of (V, V)
// (the compact table (S + 1, S): row 0 the surface voxels' flat indices as
// floats, then the S x S stiffnesses). It is the pass above run over the S
// entries in place of the V voxels: the same tile mask and active bits over
// 32-entry groups of the surface order, the same cull and the same row
// owners. Staging gathers each entry's voxel through the index row
// (pair_stage<true>), and a row's force goes to its voxel (pair_contact_block
// <true>; the indices are distinct, so nothing collides). On the TPU the
// gather and the scatter are one-hot matrix products. The collision system
// orders the surface as the flat x-major order (np.argwhere), so a row
// meets its nonzero terms in the dense row's order, each by the same
// arithmetic, and culled tiles and zero entries add exactly 0: where a warp
// owns each of its groups (K1), the forces equal the dense pass's bit for
// bit. The caller writes -0 to the voxels off the surface, as the dense
// pass's zero rows give them. Bound: as the dense pass, over S^2 entries.
#pragma once
#include <string.h>

// The host build (tests/cuda_host) runs one thread a block. The warp-wide
// steps below are written once, over the lanes: each hands a function of
// the lane l to warp_ballot, warp_fold or warp_nonzero, which on the card
// evaluate it in lane l and combine over the warp (__ballot_sync, the
// __shfl_xor_sync butterfly) and in the host build loop over the 32 lanes
// and combine in the same order (tests/cuda_host/cuda_runtime.h). There
// each routine runs as the block's warp 0, lane 0; pair_contact_block
// loops over the block's warps and lanes itself.
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

// the lanes l of the warp for which pred(l) holds, a bit each
template <class P>
__device__ __forceinline__ unsigned warp_ballot(P pred) {
    return __ballot_sync(0xffffffffu, pred(PAIR_LANE));
}

// op folded over f(0) .. f(31) by the xor butterfly, the same in every
// lane; T: a struct of floats (or a float)
template <class T, class F, class Op>
__device__ __forceinline__ T warp_fold(F f, Op op) {
    static_assert(sizeof(T) % sizeof(float) == 0, "warp_fold: a struct of floats");
    constexpr int N = sizeof(T) / sizeof(float);
    T v = f(PAIR_LANE);
    for (int o = 16; o > 0; o >>= 1) {
        float a[N];
        memcpy(a, &v, sizeof(T));
#pragma unroll
        for (int k = 0; k < N; ++k) a[k] = __shfl_xor_sync(0xffffffffu, a[k], o);
        T w;
        memcpy(&w, a, sizeof(T));
        v = op(v, w);
    }
    return v;
}

// bits[k]: the lanes l whose load(l, k) is nonzero, for k < U; every lane
// issues its U loads before the first ballot
template <int U, class L>
__device__ __forceinline__ void warp_nonzero(unsigned (&bits)[U], L load) {
    float a[U];
#pragma unroll
    for (int k = 0; k < U; ++k) a[k] = load(PAIR_LANE, k);
#pragma unroll
    for (int k = 0; k < U; ++k) bits[k] = __ballot_sync(0xffffffffu, a[k] != 0.f);
}
#endif

// table loads in flight a lane while the static mask is read
#define PAIR_MASK_UNROLL 16

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// 32-voxel groups of a body, and 32-bit words of a tile-mask row
__host__ __device__ inline int pair_groups(int V) { return (V + 31) >> 5; }
__host__ __device__ inline int pair_words(int G) { return (G + 31) >> 5; }
// floats of the staged positions and scales: a float4 a voxel, whole groups
__host__ __device__ inline int pair_stage_floats(int V) { return 128 * pair_groups(V); }
// floats of the boxes (8 a group), the tile mask (G x W words) and the
// active-voxel bits (a word a group)
__host__ __device__ inline int pair_aux_floats(int V) {
    const int G = pair_groups(V);
    return 9 * G + G * pair_words(G);
}
__device__ __forceinline__ unsigned* pair_mask(float* aux, int G) {
    return reinterpret_cast<unsigned*>(aux + 8 * G);
}
__device__ __forceinline__ const unsigned* pair_mask(const float* aux, int G) {
    return reinterpret_cast<const unsigned*>(aux + 8 * G);
}
// words of the tile mask and the active bits together
__host__ __device__ inline int pair_table_words(int V) {
    const int G = pair_groups(V);
    return G * pair_words(G) + G;
}

// The static tile mask and the active bits, `tables` (pair_table_words,
// the mask's G x W words, then a word a group), from rows [r0, r1) of the
// robot's table, by the whole block, on cleared words, a barrier after: a
// tile's bit is set when one of these rows holds a nonzero entry in it, a
// voxel's when its row (among these) or its column (within these rows)
// holds one. Blocks that take the rows in parts may share the words.
__device__ inline void pair_tile_mask(const float* __restrict__ a1, int V, unsigned* tables,
                                      int r0, int r1) {
    const int G = pair_groups(V);
    const int W = pair_words(G);
    unsigned* mask = tables;
    unsigned* act = mask + G * W;
    for (int i = r0 + PAIR_WARP; i < r1; i += PAIR_NWARPS) {
        const float* row = a1 + (size_t)i * V;
        unsigned* mrow = mask + (i >> 5) * W;
        bool any = false;
        for (int h0 = 0; h0 < G; h0 += PAIR_MASK_UNROLL) {
            unsigned bits[PAIR_MASK_UNROLL];
            warp_nonzero(bits, [&](int l, int k) {
                const int j = (h0 + k) * 32 + l;
                return j < V ? __ldg(row + j) : 0.f;
            });
#pragma unroll
            for (int k = 0; k < PAIR_MASK_UNROLL; ++k) {
                if (bits[k] == 0u) continue;
                any = true;
                if (PAIR_LANE == 0) {
                    // a read first: most bits are set after the first rows
                    const int h = h0 + k;
                    const unsigned bit = 1u << (h & 31);
                    if (!(mrow[h >> 5] & bit)) atomicOr(&mrow[h >> 5], bit);
                    if (bits[k] & ~act[h]) atomicOr(&act[h], bits[k]);
                }
            }
        }
        if (any && PAIR_LANE == 0) atomicOr(&act[i >> 5], 1u << (i & 31));
    }
}

// the compact pass's index row, the one argument of its pack
__device__ __forceinline__ const float* pair_idx(const float* idx) { return idx; }

// a row's force, negated, to voxel o of out (c * out_stride + o)
__device__ __forceinline__ void pair_put(float* out, int out_stride, int o, float fx, float fy,
                                         float fz) {
    out[o] = -fx;
    out[out_stride + o] = -fy;
    out[2 * out_stride + o] = -fz;
}

// a group's box while the warp folds it: lows, highs, the largest scale
struct PairBox {
    float lx, ly, lz, hx, hy, hz, sm;
};

// Stages the robot's positions and scales (x, y, z, s: V floats each) as
// float4s in sp, zeros past V, and writes each group's box over its active
// voxels to aux: {lo.x, lo.y, lo.z, smax}, {hi.x, hi.y, hi.z, 0}. The whole
// block; a barrier before the pass. GATHER (the compact pass), with the
// index row idx after the other arguments: V entries, entry v the voxel
// idx[v] of the grid's x, y, z, s. Without GATHER the pack is empty, so
// the dense instantiation holds nothing of the gather.
template <bool GATHER = false, class... Idx>
__device__ inline void pair_stage(const float* x, const float* y, const float* z,
                                  const float* s, int V, float* sp, float* aux, Idx... idx) {
    const int G = pair_groups(V);
    float4* s4 = reinterpret_cast<float4*>(sp);
    float4* box = reinterpret_cast<float4*>(aux);
    const unsigned* act = pair_mask(aux, G) + G * pair_words(G);
    for (int g = PAIR_WARP; g < G; g += PAIR_NWARPS) {
        // lane l stages voxel 32 g + l and boxes it if it is active
        const PairBox bx = warp_fold<PairBox>(
            [&](int l) {
                const int v = 32 * g + l;
                float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
                if constexpr (GATHER) {
                    if (v < V) {
                        const int u = (int)pair_idx(idx...)[v];
                        q = make_float4(x[u], y[u], z[u], s[u]);
                    }
                } else {
                    if (v < V) q = make_float4(x[v], y[v], z[v], s[v]);
                }
                s4[v] = q;
                const bool on = v < V && ((act[g] >> l) & 1u);
                return PairBox{on ? q.x : INFINITY, on ? q.y : INFINITY, on ? q.z : INFINITY,
                               on ? q.x : -INFINITY, on ? q.y : -INFINITY,
                               on ? q.z : -INFINITY, on ? q.w : 0.f};
            },
            [](const PairBox& a, const PairBox& b) {
                return PairBox{fminf(a.lx, b.lx), fminf(a.ly, b.ly), fminf(a.lz, b.lz),
                               fmaxf(a.hx, b.hx), fmaxf(a.hy, b.hy), fmaxf(a.hz, b.hz),
                               fmaxf(a.sm, b.sm)};
            });
        if (PAIR_LANE == 0) {
            box[2 * g] = make_float4(bx.lx, bx.ly, bx.lz, bx.sm);
            box[2 * g + 1] = make_float4(bx.hx, bx.hy, bx.hz, 0.f);
        }
    }
}

// Whether tile (g, h) can hold a touching pair: the boxes' gap against the
// larger contact radius (the argument at the top).
__device__ __forceinline__ bool pair_tile_near(const float4* box, int g, int h, float slack) {
    const float4 gl = box[2 * g], gh = box[2 * g + 1];
    const float4 hl = box[2 * h], hh = box[2 * h + 1];
    const float gx = fmaxf(fmaxf(hl.x - gh.x, gl.x - hh.x), 0.f);
    const float gy = fmaxf(fmaxf(hl.y - gh.y, gl.y - hh.y), 0.f);
    const float gz = fmaxf(fmaxf(hl.z - gh.z, gl.z - hh.z), 0.f);
    const float gap2 = gx * gx + gy * gy + gz * gz;
    const float r = (0.75f * (gl.w + hl.w)) * slack;
    return gap2 < r * r;
}

// The hot tiles of row group g among column groups 32 w .. 32 w + 31: its
// static mask word and the cull, the same in every lane. counts (or null):
// [0] tiles evaluated, [1] culled by distance, [2] culled statically.
__device__ inline unsigned pair_hot_word(const float* aux, int G, int W, int g, int w,
                                         float slack, int lane, unsigned* counts) {
    const float4* box = reinterpret_cast<const float4*>(aux);
    const unsigned m = pair_mask(aux, G)[g * W + w];
    const unsigned near = warp_ballot([&](int l) {
        const int h = 32 * w + l;
        return h < G && pair_tile_near(box, g, h, slack);
    });
    if (counts && lane == 0) {
        const int n = G - 32 * w;
        const unsigned valid = n >= 32 ? 0xffffffffu : (1u << n) - 1u;
        atomicAdd(counts, (unsigned)__popc(m & near));
        atomicAdd(counts + 1, (unsigned)__popc(m & ~near));
        atomicAdd(counts + 2, (unsigned)__popc(valid & ~m));
    }
    return m & near;
}

// Walks row group g's hot tiles in ascending order, every split-th from the
// part-th on (the word loop is the same in every lane of the warp).
struct PairHot {
    const float* aux;
    unsigned* counts;  // null, or counted by part 0
    float slack;
    int G, W, g, part, split, lane;
    int w, k;
    unsigned bits;

    __device__ int next() {
        for (;;) {
            while (bits == 0u) {
                if (++w >= W) return -1;
                bits = pair_hot_word(aux, G, W, g, w, slack, lane, part == 0 ? counts : nullptr);
            }
            const int h = 32 * w + __ffs(bits) - 1;
            bits &= bits - 1u;
            if (k++ % split == part) return h;
        }
    }
};

// A lane's 32 entries of tile (row, h): row points at its table row; live
// false (a row past V) loads nothing.
__device__ __forceinline__ void pair_load(float (&a)[32], const float* row, int h, int V,
                                          bool vec, bool live) {
    const int j0 = 32 * h;
    const int n = live ? min(32, V - j0) : 0;
    if (vec) {
        const float4* r4 = reinterpret_cast<const float4*>(row + j0);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const float4 t = 4 * q < n ? __ldg(r4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
            a[4 * q] = t.x;
            a[4 * q + 1] = t.y;
            a[4 * q + 2] = t.z;
            a[4 * q + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < 32; ++k) a[k] = k < n ? __ldg(row + j0 + k) : 0.f;
    }
}

// A row's terms over one tile, ascending by column; pj: the column group's
// staged voxels (zeros past V, where a1 is 0 too), me: the row's own. The
// gate compiles to predicated instructions over the unrolled columns (a
// select in its place, adding 0 * d as the plain version does, raised K1's
// registers to 248-255 with spills for ~3 % of a step: H100,
// chip_smoke.py --pair in turns).
__device__ __forceinline__ void pair_tile_sum(const float (&a)[32], const float4* pj, float4 me,
                                              float& fx, float& fy, float& fz) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
        const float4 q = pj[k];
        const float dx = q.x - me.x;
        const float dy = q.y - me.y;
        const float dz = q.z - me.z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        // rsqrtf, as torch.rsqrt on the card and lax.rsqrt in the TPU kernel
        const float inv = rsqrtf(fmaxf(d2, 1e-30f));
        const float tt = (0.75f * (me.w + q.w)) * inv;
        if (tt > 1.f) {
            const float mag = a[k] * (tt - 1.f);
            fx += mag * dx;
            fy += mag * dy;
            fz += mag * dz;
        }
    }
}

// One lane's row of group g over the hot tiles `it` hands it, the next
// tile's loads issued before the current tile's arithmetic.
__device__ inline void pair_row(const float4* s4, const float* __restrict__ a1, int V, int g,
                                int lane, bool vec, PairHot& it, float& fx, float& fy,
                                float& fz) {
    const int i = 32 * g + lane;
    const bool live = i < V;
    const float4 me = s4[i];
    const float* row = a1 + (size_t)(live ? i : 0) * V;
    float a[32], b[32];
    int h0 = it.next();
    if (h0 < 0) return;
    pair_load(a, row, h0, V, vec, live);
    for (;;) {
        const int h1 = it.next();
        if (h1 >= 0) pair_load(b, row, h1, V, vec, live);
        pair_tile_sum(a, s4 + 32 * h0, me, fx, fy, fz);
        if (h1 < 0) return;
        h0 = it.next();
        if (h0 >= 0) pair_load(a, row, h0, V, vec, live);
        pair_tile_sum(b, s4 + 32 * h1, me, fx, fy, fz);
        if (h0 < 0) return;
    }
}

// The pass over row groups [g0, g1) of one robot, by the whole block, after
// pair_tile_mask and pair_stage (and a barrier): out[c * out_stride + i]
// receives force component c on voxel i for those rows. sp, aux: as staged;
// a1: the robot's V x V table, row-major; slack: 1 + the cull's margin;
// partial: null (a warp owns each of its groups), or split * (g1 - g0) * 96
// floats where the block has at least twice as many warps as groups;
// counts: null, or the three tile counts of pair_hot_word; nwarps: the
// block's warps (the host build loops over them). SCATTER (the compact
// pass), with the index row idx after the other arguments: V entries, row
// i's force to voxel idx[i] of out; without it the pack is empty.
template <bool SCATTER = false, class... Idx>
__device__ inline void pair_contact_block(const float* sp, const float* __restrict__ a1, int V,
                                          const float* aux, float* out, int out_stride, int g0,
                                          int g1, float* partial, float slack,
                                          unsigned* counts, int nwarps, Idx... idx) {
    const int G = pair_groups(V);
    const int W = pair_words(G);
    const int ng = g1 - g0;
    const int split = partial && nwarps >= 2 * ng ? nwarps / ng : 1;
    const int units = ng * split;
    const bool vec = (V & 3) == 0 && (reinterpret_cast<size_t>(a1) & 15) == 0;
    const float4* s4 = reinterpret_cast<const float4*>(sp);
#ifdef EVOSORO_HOST_EMULATION
    for (int warp = 0; warp < nwarps; ++warp)
        for (int lane = 0; lane < 32; ++lane)
#else
    const int warp = PAIR_WARP;
    const int lane = PAIR_LANE;
#endif
            for (int u = warp; u < units; u += nwarps) {
                const int g = g0 + u / split;
                PairHot it = {aux, counts, slack, G, W, g, u % split, split, lane, -1, 0, 0u};
                float fx = 0.f, fy = 0.f, fz = 0.f;
                pair_row(s4, a1, V, g, lane, vec, it, fx, fy, fz);
                const int i = 32 * g + lane;
                if (split > 1) {
                    partial[(u * 3) * 32 + lane] = fx;
                    partial[(u * 3 + 1) * 32 + lane] = fy;
                    partial[(u * 3 + 2) * 32 + lane] = fz;
                } else if (i < V) {
                    if constexpr (SCATTER) {
                        pair_put(out, out_stride, (int)pair_idx(idx...)[i], fx, fy, fz);
                    } else {
                        out[i] = -fx;
                        out[out_stride + i] = -fy;
                        out[2 * out_stride + i] = -fz;
                    }
                }
            }
    if (split > 1) {
        __syncthreads();
        for (int t = threadIdx.x; t < ng * 32; t += blockDim.x) {
            const int gl = t >> 5, l = t & 31;
            const int i = 32 * (g0 + gl) + l;
            if (i >= V) continue;
            float fx = 0.f, fy = 0.f, fz = 0.f;
            for (int p = 0; p < split; ++p) {
                const float* q = partial + (size_t)((gl * split + p) * 3) * 32 + l;
                fx += q[0];
                fy += q[32];
                fz += q[64];
            }
            if constexpr (SCATTER) {
                pair_put(out, out_stride, (int)pair_idx(idx...)[i], fx, fy, fz);
            } else {
                out[i] = -fx;
                out[out_stride + i] = -fy;
                out[2 * out_stride + i] = -fz;
            }
        }
    }
}
