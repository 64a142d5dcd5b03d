// K1's step loop for the H100, and B4's recompute (its TAPE form). It
// computes the bits of the old mapping (a thread a voxel and its three
// bonds, the sums over a 256-thread block), which is gone: only which
// thread does which piece of work, and where the state lives during a
// launch, differ.
//
// Bound on this card: the latency of one block's step (fused_rollout.cu).
// A 256-thread block left 8 warps on an SM at 10^3 (the bond forces' 144 KB
// of shared memory admit one block) and ran each thread's voxels' three
// bonds in series, a few hundred dependent operations each, every state
// load a round trip to device memory. So:
// 1. Bond items. Phase A walks the 3 V bonds (v, d) d-major, one item a
//    thread (neighbouring threads, neighbouring voxels); phase B stays a
//    voxel a thread. Each kernel takes as many threads as its registers
//    allow (k1_bound, its __launch_bounds__ with one block an SM); the
//    launch takes min(that, 3 V rounded up to a warp) (k1_threads).
// 2. Resident state (RES). Where the buffer and the robot's C_S x V state
//    fit one block's shared memory together (ops/fused_rollout.py
//    k1_resident: every evolution body), the block copies the state in
//    once, steps on the copy and writes it back once.
// 3. Sums keep their order. Every block sum and minimum folds the
//    partials of the first k1_red_threads(V) threads, the block size of the
//    old mapping, each over voxels tid, tid + P, ... ascending (part_sum3,
//    part_min3); a step that sums over phase B's voxels (a trace sample,
//    equilibrium mode) strides that phase by P. The volume instance's dt
//    maximum runs over every thread, which a maximum of these values does
//    not notice; the divergence flag is an OR.
#pragma once
#include "fused_rollout_common.cuh"

// Threads a block of each K1 kernel can take: its __launch_bounds__(n, 1)
// (ptxas: 65536 / n registers a thread), each the fastest of 256, 384 and
// 512 on the card (PERF.md section 6): 512, 16 warps, but 384 for the
// kernels with a pair pass (dense or compact) and the features or the
// material options. At 512 the kernels without contact take 107-128
// registers (up to 56 bytes of spills in four feature instances) and the
// land, water and growth kernels with the pass 128 and 0-48 bytes of
// spills, and beat 256 and 384 threads; the feature instances with the
// pass spilled 52-220 bytes there and lost to the parent's kernels. The
// compact instances at 512 won 2-12 % on 1024 robots and lost 19-28 % on
// a one-robot replay (PERF.md section 6, PR 15).
constexpr int K1_THREADS = 512;
constexpr int K1_DENSE_OPT_THREADS = 384;
// the __launch_bounds__ of a K1 kernel: the material and volume instances
// (mat), with a pair pass (pass: the dense one or the compact one), with the
// fitness features (feat)
__host__ __device__ constexpr int k1_bound(bool mat, bool pass, bool feat) {
    return pass && (mat || feat) ? K1_DENSE_OPT_THREADS : K1_THREADS;
}

// The threads whose partials a reduction folds: the old mapping's block,
// min(V rounded up to a warp, 256); one in the host build (one thread a
// block)
constexpr int K1_RED_THREADS = 256;
static_assert(K1_DENSE_OPT_THREADS >= K1_RED_THREADS && K1_THREADS <= 1024,
              "a block holds the reductions' partition");
__host__ __device__ inline int k1_red_threads(int V) {
#ifdef EVOSORO_HOST_EMULATION
    return 1;
#else
    return V >= K1_RED_THREADS ? K1_RED_THREADS : ((V + 31) / 32) * 32;
#endif
}

// K1's block for a body of V grid cells: a thread a bond item (3 V rounded
// up to a warp) up to the kernel's bound, so never fewer threads than the
// reductions' partition; the device-memory twins take the same
__host__ __device__ constexpr int k1_threads(int V, bool mat, bool pass, bool feat) {
    return k1_bound(mat, pass, feat) < (3 * V + 31) / 32 * 32 ? k1_bound(mat, pass, feat)
                                                                : (3 * V + 31) / 32 * 32;
}

// B4's tape (k1_steps' TAPE form): slots `slot` floats apart, the steps'
// clocks, and where thread 0 leaves the count of steps taken
struct K1Tape {
    size_t slot;
    float* clock;
    int* taken;
};
template <class T>
__device__ inline const T& k1_tape(const T& t) { return t; }

// The step loop of one robot, run by its whole block, in place on st (the
// robot's C_S x V state in device memory). r carries time, divergence
// latch, IniCM and the capture flag in and out. A robot that is frozen
// (diverged, or past its stop time) leaves the loop: the steps it skips
// change nothing.
//
// sh: k1_buffer_floats of shared memory (or device memory); RES: the
// state's copy past them. scr: the robot's 6 * V floats of scratch in
// device memory (V_FLUID_MESH only). FEAT: the fitness features, on the
// carry fe with the constants fp. MAT: the material instance (of any
// variant) with the inputs ma and the kinetic-energy ring ke (6 floats, the
// same in every thread). VOL (with MAT): volume effects, with
// the inputs va; r.dt is the dt carried in and out. DENSE: contact through
// the dense pair pass on the V x V table a1 (pair_contact.cuh). COMPACT
// (with MAT, not DENSE): contact through the same pass over the S =
// ma->n_surf surface voxels of the compact table a1 (S + 1, S): its index
// row, then the S x S table.
//
// TAPE (B4's recompute; not with RES), with one K1Tape after the other
// arguments: out of place. Step i reads slot i (st + i * slot) and writes
// slot i + 1, so the state every step started from is kept; it also leaves
// its clock in clock[i] and each voxel's static-friction decision in
// channel S_DIFF of slot i, carries a masked bond's small-angle flag and a
// changed bond's old damping memory into the new slot (in place they stay
// where they are), and with the facet drag leaves its per-side strains
// past scr + i * slot, in its own slot. Without TAPE the pack is empty and
// every instance compiles to what it was before the tape came.
template <int VARIANT, bool FEAT = false, bool MAT = false, bool VOL = false,
          bool DENSE = false, bool RES = false, bool TAPE = false, bool COMPACT = false,
          class... Tape>
__device__ inline void k1_steps(float* st, const float* bo, const float* a1,
                                const float* cu_robot, int n_knots, int knot_steps,
                                int step_base, int X, int Y, int Z, int num_steps,
                                const Params& p, int flags, Robot& r, float* sh, float* scr,
                                Feat* fe = nullptr, const FeatParams* fp = nullptr,
                                const MatArgs* ma = nullptr, float* ke = nullptr,
                                const VolArgs* va = nullptr, Tape... tape) {
    // the reductions' scratch holds a word for each of 24 warps (block_max1)
    static_assert(k1_bound(MAT, DENSE || COMPACT, FEAT) <= 768,
                  "block_max1: a word of red a warp");
    static_assert(!TAPE || (sizeof...(Tape) == 1 && !RES), "a K1Tape, in device memory");
    static_assert(!COMPACT || (MAT && !DENSE), "the compact table's surface count rides MatArgs");
    __shared__ float red[3 * (K1_RED_THREADS / 32)];
    __shared__ int divflag[2];

    const int V = X * Y * Z;
    const int T = blockDim.x;
    const int P = k1_red_threads(V);  // the reductions' partition
    // contact forces, from the dense pass or the compact one (which the
    // host launches only with F_COLL)
    const bool coll = DENSE || COMPACT;
    const int S = COMPACT ? ma->n_surf : V;  // the pass's entries
    float* bf = sh;                          // [36][V] bond forces
    float* sp = sh + BF * V;                 // the pass's float4s, an entry each
    float* aux = sp + pair_stage_floats(S);  // its tables
    float* fc = aux + (coll ? pair_aux_floats(S) : 0);  // [3][V] contact forces
    const int strides[3] = {Y * Z, Z, 1};
    // the state the steps read and write: the robot's own in device memory,
    // or (RES) its copy past the buffer, read in here and written back after
    float* const ss =
        RES ? sh + k1_buffer_floats(V, (flags & F_COLL) != 0, COMPACT ? S : 0) : st;

    float t = r.t;
    bool div = r.div;
    const float dt0 = r.dt;
    float dt_c = r.dt;  // (volume effects) the dt of the last step taken
    F3 ini = r.ini;
    bool capt = r.capt;
    const float inv_m = r.inv_m;
    const float stop_t = r.stop_t;
    const float init_cm = r.init_cm;
    const float grav = r.grav;
    const float dt_inv0 = r.dt_inv;

    if (threadIdx.x < 2) divflag[threadIdx.x] = 0;
    if constexpr (RES) {
        for (int k = threadIdx.x; k < C_S * V; k += T) ss[k] = st[k];
    }
    if constexpr (FEAT) {
        for (int k = threadIdx.x; k < 2 * MAX_WIN; k += blockDim.x) feat_ring()[k] = 0.f;
    }
    if constexpr (DENSE || COMPACT) {
        unsigned* tables = pair_mask(aux, pair_groups(S));  // the tile mask, active bits
        for (int k = threadIdx.x; k < pair_table_words(S); k += T) tables[k] = 0u;
    }
    __syncthreads();
    // the pass's static tile mask, once a launch (the compact table's S x S
    // entries past its index row)
    if constexpr (DENSE || COMPACT) {
        pair_tile_mask(a1 + (COMPACT ? S : 0), S, pair_mask(aux, pair_groups(S)), 0, S);
        __syncthreads();
    }

#define SCH(k) (si + (size_t)(k) * V)
#define SOUT(k) (so + (size_t)(k) * V)
#define BCH(k) (bo + (size_t)(k) * V)

    int i = 0;
    for (; i < num_steps; ++i) {
        const int i_glob = step_base + i;
        // the step's dt: under volume effects the bond pass damps with the
        // carried one and everything after it takes the one recomputed
        float dt = dt0;
        float dt_inv = dt_inv0;
        if constexpr (VOL) {
            dt = dt_c;
            dt_inv = sdiv(1.f, dt_c);
        }
        // the state is read and written within the launch: no read-only cache
        const float* si = ss;
        float* so = ss;
        if constexpr (TAPE) {
            si = st + (size_t)i * k1_tape(tape...).slot;
            so = st + (size_t)(i + 1) * k1_tape(tape...).slot;
        }
        // ---- rollout bookkeeping from the previous step's positions ----
        const bool capture = !capt && (t > init_cm);
        const bool take = capture || (i_glob == 0 && !capt);
        if (take) {
            F3 part = {0.f, 0.f, 0.f};
            for (int v = threadIdx.x < P ? (int)threadIdx.x : V; v < V; v += P) {
                const float m = BCH(B_MASS)[v];
                part.x += SCH(S_POS + 0)[v] * m;
                part.y += SCH(S_POS + 1)[v] * m;
                part.z += SCH(S_POS + 2)[v] * m;
            }
            const F3 s = part_sum3(part, red, P);
            ini = {s.x * inv_m, s.y * inv_m, s.z * inv_m};
        }
        capt = capt || capture;
        // with the features, a frozen robot's last step runs "dry": it writes
        // no state, only the trace sample the JAX kernel takes from it
        bool dry = false;
        bool sample = false;  // a trace sample is due after this step
        if constexpr (FEAT) {
            const bool fell = feat_top(*fe, *fp, p, si, bo, V, i, i_glob, t, stop_t, init_cm,
                                       flags, red, P);
            if (flags & F_TRACE) sample = feat_trace_due(*fe, *fp, t + dt, init_cm);
            if (div || t >= stop_t || fell) {
                // under volume effects whether a sample is due waits for the
                // step's own dt: the step runs dry to find it
                if (!(sample || (VOL && (flags & F_TRACE)))) {
                    if (flags & F_TRACE)
                        feat_trace(*fe, *fp, p, t + dt, false, 0.f, 0.f, init_cm, flags);
                    feat_tail(*fe, *fp, i, num_steps);
                    break;
                }
                dry = true;
            }
        } else {
            if (div || t >= stop_t) break;  // frozen: nothing changes any more
        }
        if constexpr (TAPE)
            if (threadIdx.x == 0) k1_tape(tape...).clock[i] = t;

        // equilibrium mode: the ring's test before this step's energy is
        // pushed (VX_Sim.cpp:1148-1155)
        bool zero_motion = false;
        if constexpr (MAT)
            zero_motion = (flags & F_EQUIL) && ke[0] + ke[1] + ke[2] < ke[3] + ke[4] + ke[5];

        // this step's control knot: a row of the robot's (K, V) controls
        const float* cu = nullptr;
        if (n_knots > 0)
            cu = cu_robot + (size_t)knot_of(i_glob, n_knots, knot_steps) * V;

        // ---- phase A: bond pass (+ staging for the pair pass) ----
        if constexpr (COMPACT) {
            // the surface voxels through the index row; the others feel -0,
            // as the dense pass's zero rows give them
            for (int v = threadIdx.x; v < V; v += T) {
                fc[v] = -0.f;
                fc[V + v] = -0.f;
                fc[2 * V + v] = -0.f;
            }
            pair_stage<true>(SCH(S_POS + 0), SCH(S_POS + 1), SCH(S_POS + 2), SCH(S_SCALE), S,
                             sp, aux, a1);
            __syncthreads();
            pair_contact_block<true>(sp, a1 + S, S, aux, fc, V, 0, pair_groups(S), nullptr,
                                     p.pair_slack, nullptr, PAIR_NWARPS, a1);
        } else if constexpr (DENSE) {
            pair_stage(SCH(S_POS + 0), SCH(S_POS + 1), SCH(S_POS + 2), SCH(S_SCALE), V, sp, aux);
            __syncthreads();
            pair_contact_block(sp, a1, V, aux, fc, V, 0, pair_groups(V), nullptr, p.pair_slack,
                               nullptr, PAIR_NWARPS);
        }
        int diverging = 0;
        float f2max = 0.f;  // (volume effects) this thread's largest k_eff / m
        const float vt[3] = {t, r.tamp, r.tper};
        // one bond item (v, d)
        const auto bond_item = [&](int d, int v) {
            const float* bd = bo + (size_t)(B_DIR + d * B_PER_DIR) * V + v;
            float* out = bf + (size_t)d * 12 * V + v;
            float* lp2p = SOUT(S_LP2 + 3 * d) + v;
            float* la1p = SOUT(S_LA1 + 3 * d) + v;
            float* la2p = SOUT(S_LA2 + 3 * d) + v;
            if (!(bd[(size_t)D_MASK * V] > 0.5f)) {
                if (VARIANT == V_FLUID_MESH) {
                    scr[(size_t)d * V + v] = 0.f;
                    scr[(size_t)(3 + d) * V + v] = 0.f;
                }
                if constexpr (VOL) va->scr[(size_t)d * V + v] = 0.f;
                for (int k = 0; k < 12; ++k) out[(size_t)k * V] = 0.f;
                if (dry) return;
                for (int c = 0; c < 3; ++c) {
                    lp2p[(size_t)c * V] = 0.f;
                    la1p[(size_t)c * V] = 0.f;
                    la2p[(size_t)c * V] = 0.f;
                }
                SOUT(S_MAXS + d)[v] = 0.f;
                if constexpr (MAT)
                    if (flags & F_PLASTIC) SOUT(S_SOFF + d)[v] = 0.f;
                if constexpr (TAPE) SOUT(S_SMALL + d)[v] = SCH(S_SMALL + d)[v];
                return;
            }
            float soff = 0.f;
            float vo[2];  // (volume effects) the bond's Eh and CSavg
            // (the material instances of the facet drag) the per-side strains
            // of the stress equalization
            float sides[4];
            const Bond bn = bond_forward<MAT, VOL, false, MAT ? VARIANT : V_LAND>(
                si, bd, v, v + strides[d], d, V, p, dt, dt_inv, ma, flags, &soff, vt, vo, sides);
            if constexpr (VOL) {
                // the strain the voxel pass couples (0 on a heterogeneous
                // bond), and k_eff = Eh (CS1 + CS2) / (2 (e L + L)) over
                // the lighter side's mass (core/step.py sim_step)
                va->scr[(size_t)d * V + v] = bd[(size_t)D_HOM * V] > 0.5f ? bn.strain : 0.f;
                const float eff_k = vo[0] * (vo[1] + vo[1]) / (2.f * (bn.strain * p.L + p.L));
                const float f2 = fmaxf(sdiv(eff_k, BCH(B_MASS)[v]),
                                       sdiv(eff_k, BCH(B_MASS)[v + strides[d]]));
                f2max = fmaxf(f2max, f2);
            }
            if constexpr (MAT)
                if ((flags & F_PLASTIC) && !dry) SOUT(S_SOFF + d)[v] = soff;
            if (!dry) SOUT(S_MAXS + d)[v] = fmaxf(SCH(S_MAXS + d)[v], bn.strain);
            if (fabsf(bn.strain) > 100.f) diverging = 1;
            if (VARIANT == V_FLUID_MESH) {
                // per-side strains, the linear fixed point of the stress
                // equalization (VXS_BondInternal.cpp:237-253)
                const float E1 = bd[(size_t)D_E1 * V], E2 = bd[(size_t)D_E2 * V];
                const float s_sum = E1 + E2;
                const bool hom = (bd[(size_t)D_HOM * V] > 0.5f) ||
                                 fabsf(E1 - E2) <= p.near_eq * fabsf(s_sum);
                scr[(size_t)d * V + v] =
                    hom ? bn.strain : 2.f * sdiv(E2, s_sum) * bn.strain;
                scr[(size_t)(3 + d) * V + v] =
                    hom ? bn.strain : 2.f * sdiv(E1, s_sum) * bn.strain;
                // the material instances: the strains of the stress branch
                // that ran (_bond_dir :508-554). Under volume effects the
                // bond strain on a homogeneous bond, 0 on a heterogeneous
                // one, with no near-equal widening; with nonlinear materials
                // the stress equalization's sides
                if constexpr (MAT) {
                    if (VOL || (flags & F_NONLINEAR)) {
                        const float s1 = VOL ? (bd[(size_t)D_HOM * V] > 0.5f ? bn.strain : 0.f)
                                             : sides[0];
                        const float s2 = VOL ? s1 : sides[1];
                        scr[(size_t)d * V + v] = s1;
                        scr[(size_t)(3 + d) * V + v] = s2;
                    }
                }
            }

            // back to the world frame (:159-170)
            const F3 f1 = to_orig(d, qrot_inv(bn.totrot, bn.f1));
            const F3 f2 = to_orig(d, qrot_inv(bn.totrot, bn.f2));
            const F3 m1 = to_orig(d, qrot_inv(bn.totrot, bn.m1));
            const F3 m2 = to_orig(d, qrot_inv(bn.totrot, bn.m2));
            out[0] = f1.x; out[(size_t)V] = f1.y; out[(size_t)2 * V] = f1.z;
            out[(size_t)3 * V] = m1.x; out[(size_t)4 * V] = m1.y; out[(size_t)5 * V] = m1.z;
            out[(size_t)6 * V] = f2.x; out[(size_t)7 * V] = f2.y; out[(size_t)8 * V] = f2.z;
            out[(size_t)9 * V] = m2.x; out[(size_t)10 * V] = m2.y; out[(size_t)11 * V] = m2.z;
            if (dry) return;

            // the damping memory goes stale for one step on a hysteresis
            // transition (AddDampForces is skipped, :344-347); out of place
            // the old memory is carried into the new slot
            if constexpr (TAPE) {
                if (bn.changed) {
                    lp2p[0] = bn.lp2.x; lp2p[V] = bn.lp2.y; lp2p[2 * V] = bn.lp2.z;
                    la1p[0] = bn.la1.x; la1p[V] = bn.la1.y; la1p[2 * V] = bn.la1.z;
                    la2p[0] = bn.la2.x; la2p[V] = bn.la2.y; la2p[2 * V] = bn.la2.z;
                }
            }
            if (!bn.changed) {
                lp2p[0] = bn.pos2.x; lp2p[V] = bn.pos2.y; lp2p[2 * V] = bn.pos2.z;
                la1p[0] = bn.ra1.x; la1p[V] = bn.ra1.y; la1p[2 * V] = bn.ra1.z;
                la2p[0] = bn.ra2.x; la2p[V] = bn.ra2.y; la2p[2 * V] = bn.ra2.z;
            }
            SOUT(S_SMALL + d)[v] = bn.small ? 1.f : 0.f;
        };
        // bond items d-major: neighbouring threads, neighbouring voxels
        for (int it = threadIdx.x; it < 3 * V; it += T) {
            const int d = it / V;
            bond_item(d, it - d * V);
        }
        if (diverging) atomicOr(&divflag[i & 1], 1);
        __syncthreads();
        const bool div_now = divflag[i & 1] != 0;

        if constexpr (VOL) {
            // ---- the step's dt, DtFrac / (2 pi max sqrt(k_eff / m)) ----
            const float mfreq = sqrtf(block_max1(f2max, red));
            if (mfreq > 0.f) dt = va->dt_frac / (va->two_pi * mfreq);
            // ---- phase C: the voxel pass's Poisson coupling
            // (VXS_Voxel.cpp:543-632; core/step.py _volume_effects_coupling):
            // each voxel's strain per axis from its own bond and its -a
            // neighbour's, a constrained axis counting as bonded on both
            // sides; the transverse contraction on the free axes; the sums
            // and sections per bond axis, to scratch for the bond owners ----
            const float* sv = va->scr;
            float* ax = va->scr + (size_t)3 * V;
            for (int v = threadIdx.x; v < V; v += T) {
                const int coord[3] = {v / (Y * Z), (v / Z) % Y, v % Z};
                bool Tc[3];
                float c0[3];
                for (int a = 0; a < 3; ++a) {
                    const float* mk = bo + (size_t)(B_DIR + a * B_PER_DIR + D_MASK) * V;
                    const bool pd = mk[v] > 0.5f;
                    const bool nd = coord[a] > 0 && mk[v - strides[a]] > 0.5f;
                    const float sp = sv[(size_t)a * V + v];
                    const float sn = coord[a] > 0 ? sv[(size_t)a * V + v - strides[a]] : 0.f;
                    bool cons = false;
                    if (flags & F_BC)
                        cons = ma->bc[(size_t)a * V + v] > 0.5f || ma->bc[(size_t)(6 + a) * V + v] != 0.f;
                    Tc[a] = (pd && nd) || ((pd || nd) && cons);
                    const float sa = pd && nd ? 0.5f * (sp + sn) : (pd ? sp : (nd ? sn : 0.f));
                    c0[a] = Tc[a] ? sa : 0.f;
                }
                const float mu = BCH(B_POISSON)[v];
                // pow(1 + e, -mu) - 1 with core/step.py's pow and guard
                auto pw = [mu](float e) { return powf(fmaxf(1.f + e, 1e-6f), -mu) - 1.f; };
                const bool tx = Tc[0], ty = Tc[1], tz = Tc[2];
                const float cx = (!tx && ty && tz) ? pw(c0[1] + c0[2])
                                 : (!tx && !ty && tz) ? pw(c0[2])
                                 : (!tx && ty && !tz) ? pw(c0[1]) : c0[0];
                const float cy = (tx && !ty && tz) ? pw(c0[0] + c0[2])
                                 : (!tx && !ty && tz) ? pw(c0[2])
                                 : (tx && !ty && !tz) ? pw(c0[0]) : c0[1];
                const float cz = (tx && ty && !tz) ? pw(c0[0] + c0[1])
                                 : (!tx && ty && !tz) ? pw(c0[1])
                                 : (tx && !ty && !tz) ? pw(c0[0]) : c0[2];
                ax[v] = cy + cz;
                ax[(size_t)V + v] = cx + cz;
                ax[(size_t)2 * V + v] = cy + cx;
                ax[(size_t)3 * V + v] = (1.f + cy) * (1.f + cz) * va->l2;
                ax[(size_t)4 * V + v] = (1.f + cx) * (1.f + cz) * va->l2;
                ax[(size_t)5 * V + v] = (1.f + cy) * (1.f + cx) * va->l2;
            }
            __syncthreads();
            if constexpr (FEAT)
                if (flags & F_TRACE) sample = feat_trace_due(*fe, *fp, t + dt, init_cm);
        }

        // ---- phase B1 (facet drag only): each cell's thread sums its
        // voxel's forces and computes the mesh vertex at the cell's min
        // corner; both wait in slots only this cell's voxel reads ----
        if (VARIANT == V_FLUID_MESH) {
            for (int v = threadIdx.x; v < V; v += T) {
                const int coord[3] = {v / (Y * Z), (v / Z) % Y, v % Z};
                const float minv = BCH(B_MASS_INV)[v];
                const float tsm = BCH(B_2SQ_MEXS)[v];
                const F3 vel = {SCH(S_LIN)[v] * minv, SCH(S_LIN + 1)[v] * minv,
                                SCH(S_LIN + 2)[v] * minv};
                F3 tf, tm;
                force_sum(bf, fc, coll, v, coord, strides, V, vel, tsm, p, tf, tm);
                const F3 vx = mesh_vertex(si, BCH(B_OCC), scr, coord[0], coord[1], coord[2],
                                          Y, Z, V, 0.5f * p.L);
                float* own = bf + v;
                own[0] = tf.x; own[(size_t)V] = tf.y; own[(size_t)2 * V] = tf.z;
                own[(size_t)3 * V] = tm.x; own[(size_t)4 * V] = tm.y; own[(size_t)5 * V] = tm.z;
                own[(size_t)12 * V] = vx.x; own[(size_t)13 * V] = vx.y; own[(size_t)14 * V] = vx.z;
            }
            __syncthreads();
        }

        // ---- phase B: per-voxel force sum and integration; a step that
        // sums over the voxels here strides by the reductions' partition ----
        F3 tr = {0.f, 0.f, 0.f};  // (features) this thread's CoM-y and volume sums
        float ke_part = 0.f;      // (equilibrium mode) this thread's kinetic energy
        const int vstride = (FEAT && sample) || (MAT && (flags & F_EQUIL)) ? P : T;
        for (int v = threadIdx.x < vstride ? (int)threadIdx.x : V; v < V; v += vstride) {
            const bool occ = BCH(B_OCC)[v] > 0.5f;
            // loaded first, so the load is in flight during the force sum
            const float u_knot = cu ? __ldg(cu + v) : 0.f;
            const int coord[3] = {v / (Y * Z), (v / Z) % Y, v % Z};
            const float mass = BCH(B_MASS)[v];
            const float minv = BCH(B_MASS_INV)[v];
            const float tsm = BCH(B_2SQ_MEXS)[v];
            F3 lin = {SCH(S_LIN)[v], SCH(S_LIN + 1)[v], SCH(S_LIN + 2)[v]};
            F3 vel = {lin.x * minv, lin.y * minv, lin.z * minv};
            F3 tf, tm;
            if (VARIANT == V_FLUID_MESH) {  // summed in phase B1
                const float* own = bf + v;
                tf = {own[0], own[(size_t)V], own[(size_t)2 * V]};
                tm = {own[(size_t)3 * V], own[(size_t)4 * V], own[(size_t)5 * V]};
            } else {
                force_sum(bf, fc, coll, v, coord, strides, V, vel, tsm, p, tf, tm);
            }
            if (flags & F_GRAVITY) tf.z = tf.z + mass * grav;
            const float* bcv = nullptr;  // (BC regions) this voxel's 15 channels
            if constexpr (MAT) {
                if (flags & F_BC) {
                    bcv = ma->bc + v;
                    tf = {tf.x + bcv[(size_t)6 * V], tf.y + bcv[(size_t)7 * V],
                          tf.z + bcv[(size_t)8 * V]};
                }
            }

            if (VARIANT == V_FLUID_MESH) {
                // facets of the exposed faces; a voxel on the grid's last
                // layer has no cells for its far vertices (the host refuses it)
                if (occ && coord[0] + 1 < X && coord[1] + 1 < Y && coord[2] + 1 < Z) {
                    const F3 dr = facet_drag(bf + (size_t)12 * V, BCH(B_OCC), v, coord,
                                             X, Y, Z, vel, r.dragc);
                    tf = {tf.x + dr.x, tf.y + dr.y, tf.z + dr.z};
                }
            } else if (VARIANT == V_FLUID_FACE) {
                // voxel-face quadratic drag on exposed forward-facing faces
                // (core/step.py _fluid_drag)
                const float sc0 = SCH(S_SCALE)[v];
                const float ca = r.dragc * (sc0 * sc0);
                float* tfc[3] = {&tf.x, &tf.y, &tf.z};
                const float velc[3] = {vel.x, vel.y, vel.z};
                for (int d = 0; d < 3; ++d) {
                    const float* mk = bo + (size_t)(B_DIR + d * B_PER_DIR + D_MASK) * V;
                    const bool m_pos = mk[v] > 0.5f;
                    const bool m_neg = coord[d] > 0 && mk[v - strides[d]] > 0.5f;
                    const float vd = velc[d];
                    float drag = 0.f;
                    drag = drag + -((occ && !m_pos && vd > 0.f) ? ca * vd * vd : 0.f);
                    drag = drag + ((occ && !m_neg && -vd > 0.f) ? ca * -vd * -vd : 0.f);
                    *tfc[d] = *tfc[d] + drag;
                }
            }

            const float scale = SCH(S_SCALE)[v];
            F3 pos = {SCH(S_POS)[v], SCH(S_POS + 1)[v], SCH(S_POS + 2)[v]};
            bool static_flag = false;
            if (flags & F_FLOOR) {  // floor contact + Coulomb friction (VXS_Voxel.cpp:677-758)
                const Floor fl = floor_state(scale, pos.z, vel, BCH(B_LIN_STIFF)[v],
                                             BCH(B_UD)[v], mass, dt, flags);
                float fz = fl.normal_force - p.col_damp * tsm * vel.z;
                fz = fl.contact ? fz : 0.f;
                if (fl.stick) {
                    lin.x = 0.f; lin.y = 0.f; vel.x = 0.f; vel.y = 0.f;
                    static_flag = true;
                }
                const float sf2 = tf.x * tf.x + tf.y * tf.y;
                const float surface_force = sf2 > 0.f ? sqrtf(sf2) : 0.f;
                static_flag = static_flag ||
                              (fl.contact && fl.stopped &&
                               surface_force < BCH(B_US)[v] * fl.normal_force);
                float fx = 0.f, fy = 0.f;
                if (fl.moving && fl.keeps_moving) {
                    fx = -vel.x * fl.inv_sv * fl.dyn_fric;
                    fy = -vel.y * fl.inv_sv * fl.dyn_fric;
                }
                if (fl.moving && !fl.keeps_moving) {
                    static_flag = true;
                    lin.x = 0.f;
                    lin.y = 0.f;
                }
                tf.x = static_flag ? 0.f : tf.x + fx;
                tf.y = static_flag ? 0.f : tf.y + fy;
                tf.z = tf.z + fz;
            }
            if constexpr (TAPE)
                if (!dry)
                    st[(size_t)i * k1_tape(tape...).slot + (size_t)S_DIFF * V + v] =
                        static_flag ? 1.f : 0.f;
            if (!occ) { tf = {0.f, 0.f, 0.f}; tm = {0.f, 0.f, 0.f}; }

            // Euler step (VXS_Voxel.cpp:181-197)
            lin = {lin.x + tf.x * dt, lin.y + tf.y * dt, lin.z + tf.z * dt};
            const float dtm = dt * minv;
            if constexpr (MAT) {
                F3 dp = {lin.x * dtm, lin.y * dtm, lin.z * dtm};
                if (flags & F_MAXVEL) {  // the per-step displacement clamp (:188-192)
                    const float sq = dp.x * dp.x + dp.y * dp.y + dp.z * dp.z;
                    const float dmag = sq > 0.f ? sqrtf(sq) : 0.f;
                    if (dmag > ma->max_disp) {
                        const float back = ma->max_disp / dmag;
                        dp = {dp.x * back, dp.y * back, dp.z * back};
                    }
                }
                pos = {pos.x + dp.x, pos.y + dp.y, pos.z + dp.z};
                if (bcv) {  // fixed translations sit at their prescribed place (:195-197)
                    const float nom3[3] = {((float)coord[0] + 0.5f) * p.L,
                                           ((float)coord[1] + 0.5f) * p.L,
                                           ((float)coord[2] + 0.5f) * p.L};
                    float* pc[3] = {&pos.x, &pos.y, &pos.z};
                    float* lc[3] = {&lin.x, &lin.y, &lin.z};
                    for (int c = 0; c < 3; ++c) {
                        if (!(bcv[(size_t)c * V] > 0.5f)) continue;
                        *pc[c] = nom3[c] + bcv[(size_t)(9 + c) * V];
                        *lc[c] = 0.f;
                    }
                }
            } else {
                pos = {pos.x + lin.x * dtm, pos.y + lin.y * dtm, pos.z + lin.z * dtm};
            }

            if constexpr (MAT) {
                if (bcv) {  // fixed rotations feel no moment
                    if (bcv[(size_t)3 * V] > 0.5f) tm.x = 0.f;
                    if (bcv[(size_t)4 * V] > 0.5f) tm.y = 0.f;
                    if (bcv[(size_t)5 * V] > 0.5f) tm.z = 0.f;
                }
            }

            // angular integration and quaternion update (:202-215)
            const float iinv = BCH(B_INERTIA_INV)[v];
            F3 ang;
            if constexpr (VOL) {  // a fixed angular damping (:204)
                ang = {(SCH(S_ANG)[v] + tm.x * dt) / 1.01f, (SCH(S_ANG + 1)[v] + tm.y * dt) / 1.01f,
                       (SCH(S_ANG + 2)[v] + tm.z * dt) / 1.01f};
            } else {
                const float ang_fact = 1.f - p.ten_slow * iinv * BCH(B_2SQ_IEXSSS)[v] * dt;
                ang = {(SCH(S_ANG)[v] + tm.x * dt) * ang_fact,
                       (SCH(S_ANG + 1)[v] + tm.y * dt) * ang_fact,
                       (SCH(S_ANG + 2)[v] + tm.z * dt) * ang_fact};
            }
            const Q qo = {SCH(S_QUAT)[v], SCH(S_QUAT + 1)[v], SCH(S_QUAT + 2)[v], SCH(S_QUAT + 3)[v]};
            const Q sp4 = qmul({0.f, ang.x * iinv, ang.y * iinv, ang.z * iinv}, qo);
            Q qn = {qo.w + 0.5f * sp4.w * dt, qo.x + 0.5f * sp4.x * dt,
                    qo.y + 0.5f * sp4.y * dt, qo.z + 0.5f * sp4.z * dt};
            const float l2 = qn.w * qn.w + qn.x * qn.x + qn.y * qn.y + qn.z * qn.z;
            const float li = l2 > 0.f ? 1.f / sqrtf(l2) : 1.f;
            qn = {qn.w * li, qn.x * li, qn.y * li, qn.z * li};
            if (qn.w >= 1.f) qn = {1.f, 0.f, 0.f, 0.f};

            if constexpr (MAT) {
                if (bcv && bcv[(size_t)3 * V] > 0.5f && bcv[(size_t)4 * V] > 0.5f &&
                    bcv[(size_t)5 * V] > 0.5f) {
                    // all rotations fixed: the prescribed orientation
                    // (:218-221), quat_from_rotation_vector
                    const F3 rv = {bcv[(size_t)12 * V], bcv[(size_t)13 * V], bcv[(size_t)14 * V]};
                    const float a2 = rv.x * rv.x + rv.y * rv.y + rv.z * rv.z;
                    if (a2 > 0.f) {
                        const float ang_r = sqrtf(a2);
                        const float half = 0.5f * ang_r;
                        const float sn = sinf(half);
                        qn = {cosf(half), rv.x / ang_r * sn, rv.y / ang_r * sn, rv.z / ang_r * sn};
                    } else {
                        qn = {1.f, 0.5f * rv.x, 0.5f * rv.y, 0.5f * rv.z};
                    }
                    ang = {0.f, 0.f, 0.f};
                }
            }

            if (!occ) {  // keep empty cells inert
                pos = {((float)coord[0] + 0.5f) * p.L, ((float)coord[1] + 0.5f) * p.L,
                       ((float)coord[2] + 0.5f) * p.L};
                lin = {0.f, 0.f, 0.f};
                ang = {0.f, 0.f, 0.f};
            }
            if constexpr (MAT) {
                if (flags & F_EQUIL) {
                    // ZeroAllMotion, then this voxel's share of the energy
                    // pushed (core/step.py's order of operations)
                    if (zero_motion) {
                        lin = {0.f, 0.f, 0.f};
                        ang = {0.f, 0.f, 0.f};
                    }
                    const F3 vn = {lin.x * minv, lin.y * minv, lin.z * minv};
                    const F3 wn = {ang.x * iinv, ang.y * iinv, ang.z * iinv};
                    const float inertia = iinv != 0.f ? 1.f / iinv : 0.f;
                    ke_part += 0.5f * (mass * (vn.x * vn.x + vn.y * vn.y + vn.z * vn.z) +
                                       inertia * (wn.x * wn.x + wn.y * wn.y + wn.z * wn.z));
                }
            }

            // actuation scale update (VXS_Voxel.cpp:224-341)
            float curr;
            if (VARIANT == V_FLUID_FACE || VARIANT == V_FLUID_MESH) {
                curr = fluid_scale(t, BCH(B_PHASE)[v], BCH(B_CTE)[v], r.tamp, r.tper,
                                   init_cm, p, flags);
            } else if (VARIANT == V_DEVO) {
                if constexpr (FEAT) {
                    // under ballistic development the state carries the fields
                    const bool bal = (flags & F_BALLISTIC) != 0;
                    float dv[6] = {BCH(B_INIT_SIZE)[v], BCH(B_FINAL_SIZE)[v],
                                   BCH(B_GROWTH_T)[v], BCH(B_START_GT)[v],
                                   BCH(B_FINAL_PHASE)[v], BCH(B_FINAL_AD)[v]};
                    if (bal)
                        for (int k = 0; k < 4; ++k) dv[k] = SCH(S_DEVO_DYN + k)[v];
                    curr = development_scale(t, scale, BCH(B_AMPDAMP)[v], BCH(B_PHASE)[v],
                                             BCH(B_CTE)[v], dv, r.tamp, r.tper, init_cm,
                                             r.min_tf, r.gamp, p, flags);
                    if (bal) {
                        float nd[4];
                        ballistic_rebase(t, dv, BCH(B_FINAL_SIZE)[v],
                                         development_grown(t, dv, init_cm, p, flags), *fe, *fp,
                                         init_cm, nd);
                        if (!dry)
                            for (int k = 0; k < 4; ++k) SOUT(S_DEVO_DYN + k)[v] = nd[k];
                    }
                } else {
                    const float dv[6] = {BCH(B_INIT_SIZE)[v], BCH(B_FINAL_SIZE)[v],
                                         BCH(B_GROWTH_T)[v], BCH(B_START_GT)[v],
                                         BCH(B_FINAL_PHASE)[v], BCH(B_FINAL_AD)[v]};
                    curr = development_scale(t, scale, BCH(B_AMPDAMP)[v], BCH(B_PHASE)[v],
                                             BCH(B_CTE)[v], dv, r.tamp, r.tper, init_cm,
                                             r.min_tf, r.gamp, p, flags);
                }
            } else {
                bool kept_last;
                curr = actuation_scale(
                    t, scale, BCH(B_AMPDAMP)[v], BCH(B_PHASE)[v], BCH(B_CTE)[v], r.tamp,
                    r.tper, init_cm, r.min_tf, r.gamp, p, flags, &kept_last);
            }
            const float nom = p.L;

            if (!dry) {
                SOUT(S_POS)[v] = pos.x; SOUT(S_POS + 1)[v] = pos.y; SOUT(S_POS + 2)[v] = pos.z;
                SOUT(S_QUAT)[v] = qn.w; SOUT(S_QUAT + 1)[v] = qn.x;
                SOUT(S_QUAT + 2)[v] = qn.y; SOUT(S_QUAT + 3)[v] = qn.z;
                SOUT(S_LIN)[v] = lin.x; SOUT(S_LIN + 1)[v] = lin.y; SOUT(S_LIN + 2)[v] = lin.z;
                SOUT(S_ANG)[v] = ang.x; SOUT(S_ANG + 1)[v] = ang.y; SOUT(S_ANG + 2)[v] = ang.z;
                if constexpr (VOL) {
                    // next step's side means of each bond this voxel owns; the
                    // bond pass of every thread has read the old ones
                    const float* ax = va->scr + (size_t)3 * V;
                    for (int d = 0; d < 3; ++d) {
                        const bool m = BCH(B_DIR + d * B_PER_DIR + D_MASK)[v] > 0.5f;
                        const int nb = v + strides[d];
                        const float ts1 = m ? ax[(size_t)d * V + v] : 0.f;
                        const float ts2 = m ? ax[(size_t)d * V + nb] : 0.f;
                        const float cs1 = m ? ax[(size_t)(3 + d) * V + v] : va->l2;
                        const float cs2 = m ? ax[(size_t)(3 + d) * V + nb] : va->l2;
                        SOUT(S_TSAVG + d)[v] = 0.5f * (ts1 + ts2);
                        SOUT(S_CSAVG + d)[v] = 0.5f * (cs1 + cs2);
                    }
                }
            }
            float new_scale = occ ? curr : nom;
            // MPC channel, after the clamps: the product and the sum round
            // separately, as core/step.py's control_offset does
            if (cu) new_scale = new_scale + (occ ? u_knot * nom : 0.f);
            if constexpr (FEAT) {
                if (sample) {  // the new state's CoM y (times the mass) and volume
                    tr.x += pos.y * mass;
                    if (occ) {
                        const float srel = new_scale * fp->inv_l;
                        tr.y += srel * srel * srel;
                    }
                }
                if (dry) continue;
            }
            SOUT(S_SCALE)[v] = new_scale;
        }
        if constexpr (FEAT) {
            if (flags & F_TRACE) {
                float cmy = 0.f, vol = 0.f;
                if (sample) {
                    const F3 s = part_sum3(tr, red, P);
                    cmy = s.x * inv_m;
                    vol = s.y;
                }
                feat_trace(*fe, *fp, p, t + dt, sample, cmy, vol, init_cm, flags);
            }
            if (dry) {
                feat_tail(*fe, *fp, i, num_steps);
                break;
            }
        }
        if constexpr (MAT) {
            if (flags & F_EQUIL) {  // push the step's energy onto the ring
                const float e = part_sum3({ke_part, 0.f, 0.f}, red, P).x;
                for (int k = 5; k > 0; --k) ke[k] = ke[k - 1];
                ke[0] = e;
            }
        }
        if (threadIdx.x == 0) divflag[(i + 1) & 1] = 0;
        // (facet drag, out of place) the next step's strains in its own slot
        if constexpr (TAPE && VARIANT == V_FLUID_MESH) scr += k1_tape(tape...).slot;
        t = t + dt;
        if constexpr (VOL) dt_c = dt;
        div = div || div_now;
        __syncthreads();
    }
#undef SCH
#undef SOUT
#undef BCH
    if constexpr (RES) {
        __syncthreads();
        for (int k = threadIdx.x; k < C_S * V; k += T) st[k] = ss[k];
    }
    if constexpr (VOL) r.dt = dt_c;
    r.t = t;
    r.div = div;
    r.ini = ini;
    r.capt = capt;
    if constexpr (TAPE)
        if (threadIdx.x == 0) *k1_tape(tape...).taken = i;
}
