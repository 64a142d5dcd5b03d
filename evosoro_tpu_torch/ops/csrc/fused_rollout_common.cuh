// What the forward rollout kernel (fused_rollout.cu, K1) and the reverse-mode
// segment kernel (fused_rollout_bwd.cu, B4) share: the packed channel maps,
// the launch constants, the quaternion helpers, one bond's forward pass
// (bond_forward) and the per-voxel pieces of the step. The block-wide step
// loop is k1_step.cuh's k1_steps: K1 runs it in place, B4's recompute in
// its tape form, step i reading slot i of a tape in device memory and
// writing slot i + 1, so the recompute of a segment leaves the state every
// step started from, which is what the reverse sweep needs.
//
// The step is a template over its variant, so that the land step's machine
// code carries none of the others' registers (B4 recomputes its segments
// with the variant K1 ran them in):
//   V_LAND        the evolution loop's envelope on land;
//   V_FLUID_FACE  a fluid environment with the voxel-face drag model;
//   V_FLUID_MESH  a fluid environment with facet drag on the deformed
//                 surface mesh, a corner-lattice stencil (below);
//   V_DEVO        land with the linear development ramps.
// Both fluid variants take the land_water actuation in place of the land
// one. They replace evosoro_tpu/ops/fused_rollout.py, _make_kernel:
// 1023-1058 and 1373-1451 (facet drag), 1452-1469 (voxel-face drag),
// 1610-1625 (actuation), 1628-1705 (development ramps).
//
// The facet drag (land_water VX_Sim.cpp:1516-1600) on this card: the TPU
// kernel rotates whole lane rows to bring neighbours together; here a
// neighbour is an indexed read. The vertex of the surface mesh at a cell's
// min corner is the mean of the coincident corners of the up to 8 occupied
// voxels around it; a voxel's 12 facets on its exposed faces read the 8
// vertices at its own cell and the 7 cells in +X, +Y, +Z, which is why the
// grid carries an empty shell layer there. Per step the variant adds one
// barrier: after the bond pass each cell's thread sums its voxel's forces
// (phase B1), computes its vertex from the neighbours' poses and strains,
// and parks both in slots of the bond buffer that only that cell's voxel
// reads (its own f1 of directions 0 and 1), so no shared memory is added
// and a 10^3 body in its 11^3 shell still fits with contact on; after the
// barrier the voxel reads its 8 vertices, sums its facets in place (it owns
// them: no scatter, no atomics) and integrates (phase B2). The per-side
// bond strains the corners need go through 6 floats a voxel of scratch in
// device memory, written in the bond pass. Bound by the same latency as
// the land step: one more barrier, and 8 corner rotations a cell.
//
// The fitness features are a second template parameter, FEAT, which a launch
// sets when any feature bit or an environmental source is on; with FEAT
// false the step compiles to what it was without them. They replace
// _make_kernel:912-946 and 1001-1169 (sources, end-of-life posterior Y,
// needle capture, fall-over latch), 1721-1750 (ballistic rebase of the
// development fields in state channels 56-59, variant V_DEVO only) and
// 1752-1837 (trace sampling, NormDistByVol sums, window ring and window
// distance). Every per-robot quantity is block-uniform (a robot is a block):
// each thread keeps the same copy of the carry (struct Feat), reductions hand
// every thread the same sum or minimum, and the window ring (<= 12 samples of
// CoM y and volume) lives in shared memory, written by thread 0 and zeroed at
// the start of every launch (single-call rollouts, as in the JAX kernel). The
// trace sample is taken only on steps where it is due, the end-of-life and
// needle reductions only on their capturing steps. A robot that freezes
// (diverged, past its stop time, fallen over) leaves the loop as before, but
// the JAX kernel still integrates the steps it throws away and its trace
// takes one sample from the first of them: that step runs once more without
// writing the state ("dry"), and the sources' history samples of the steps
// left are added on leaving.
//
// Voxelyze's material, solver and boundary options are a third template
// parameter, MAT, of k1_steps, instantiated for the land variant with
// and without the features in a kernel of its own (fused_rollout.cu,
// fused_rollout_mat_kernel) that a launch takes when any of them is on;
// with MAT false the step compiles to what it was without them. They replace _make_kernel:372-404
// (_vox_mat_stress_k), 513-541 and 559-573 (_bond_dir's nonlinear stress
// with the 3-iteration stress equalization and plasticity's max-strain
// memory and strain offset, state channels 53-55), 1519-1530 (the
// max-velocity clamp), 907-910 and 1589-1605 (equilibrium mode's
// kinetic-energy ring in stats channels 16-21 and the momentum zeroing),
// 966-998, 1369-1371, 1534-1542, 1556-1561, 1575-1583 (BC regions: the
// external force, pinned translations at the nominal position plus the
// prescribed displacement, fixed rotations, the prescribed orientation), and
// 734-774 (the surface-compacted contact pass, pair_contact.cuh). The
// MDL_DATA tables and the BC channels stay in device memory and are read
// per voxel where a bond or a voxel needs them; the kinetic energy is one
// more block reduction a step, through part_sum3's scratch.
//
// Volume effects are a fourth template parameter, VOL, instantiated on top
// of the material instance (fused_rollout_k1.cuh, fused_rollout_mat_kernel
// with VOL); with VOL false the step compiles to what it was. They replace
// _make_kernel:1178-1322 and _bond_dir's vol_ctx path
// (:440-506, :577), in core/step.py's order of operations: the bond's rest
// length is L, its stress Eh (1 - u) e + Eh u TSavg with Eh and u the
// harmonic means of the sides' values, less the thermal term, and its axial
// force that stress times CSavg (state channels 47-52); the step's dt is
// recomputed after the bond pass from a block-wide max of k_eff / m over the
// robot's bonds (the damping reads the carried dt, everything after it the
// new one, and the stats row's dt carries it across launches); the voxel
// pass's Poisson coupling reads each voxel's bonds' strains and its -d
// neighbours', and hands each bond owner its +d neighbour's transverse sums
// and sections. Both exchanges go through 9 floats a voxel of scratch in
// device memory, so shared memory does not grow: one block max and one more
// barrier a step. The angular damping is a fixed 1/1.01.
#pragma once
#include <cuda_runtime.h>
#include <string.h>

#include "pair_contact.cuh"

// ---- channel maps (ops/fused_rollout.py) ----
#define C_S 64
#define C_B 88
#define C_STAT 48
#define S_POS 0
#define S_QUAT 3
#define S_LIN 7
#define S_ANG 10
#define S_SCALE 13
#define S_SMALL 14
#define S_LP2 17
#define S_LA1 26
#define S_LA2 35
#define S_MAXS 44
#define S_DIFF 47  // channels [0, S_DIFF) carry the land rollout (B4's tape holds them)
#define S_TSAVG 47  // volume effects: mean transverse strain sum per bond direction
#define S_CSAVG 50  // ... and mean cross-section
#define S_SOFF 53  // plastic strain offset per bond direction (material instance)
#define B_OCC 0
#define B_MASS 1
#define B_MASS_INV 2
#define B_INERTIA_INV 3
#define B_2SQ_MEXS 4
#define B_2SQ_IEXSSS 5
#define B_LIN_STIFF 6
#define B_US 7
#define B_UD 8
#define B_CTE 9
#define B_PHASE 10
#define B_AMPDAMP 11
#define B_DIR 12
#define B_PER_DIR 20
#define D_MASK 0
#define D_HOM 1
#define D_E1 2
#define D_E2 3
#define D_E 4
#define D_A2 5
#define D_B1 6
#define D_B2 7
#define D_B3 8
#define D_DA1M1 9
#define D_DA1M2 10
#define D_DA2I1 11
#define D_DA2I2 12
#define D_DB1M1 13
#define D_DB1M2 14
#define D_DB2FM1 15
#define D_DB2FM2 16
#define D_DB3I1 17
#define D_DB3I2 18
#define ST_TIME 0
#define ST_DIV 1
#define ST_DT 2
#define ST_INICM 3
#define ST_CAPT 6
#define ST_INV_MASS 7
#define ST_STOP 8
#define ST_TAMP 9
#define ST_TPER 10
#define ST_INITCM 11
#define ST_GRAV 12
#define ST_MINTF 13
#define ST_GAMP 14
#define ST_DRAGC 15
#define ST_KE 16  // equilibrium mode's kinetic-energy ring, 6 slots
// development channels of the body
#define B_INIT_SIZE 72
#define B_FINAL_SIZE 73
#define B_GROWTH_T 74
#define B_START_GT 75
#define B_FINAL_PHASE 76
#define B_FINAL_AD 77
// material model channels of the body (the material instance's stress)
#define B_EMOD 78
#define B_POISSON 79
#define B_MTPHASE 80  // material temperature phase (volume effects' thermal term)
#define B_MATMODEL 81
#define B_PLASTIC 82
#define B_YIELD 83
#define B_MAT 84  // material id (mat-5 obstacles, mat-6 feet, mat-7 needle)
// ballistic development: the dynamic initial size, final size, growth time
// and start of growth, in state channels 56-59
#define S_DEVO_DYN 56
// stats channels of the features: per-source minimum distance, history sums
// and count; then fall latch, previous trace sample, NormDistByVol sums,
// trace count and time, window distances, count and time, needle, end-of-life
// posterior Y (ops/fused_rollout.py _S_SRC.._S_EOLCAP)
#define ST_SRC 22
#define ST_FEAT 29

// feature flags (host: ops/fused_rollout.py _K1_FLAG_BITS)
#define F_FLOOR 1
#define F_STICKY 2
#define F_GRAVITY 4
#define F_TEMP 8
#define F_FREEZE 16
#define F_COLL 32
#define F_TEMP_ENABLED 64
#define F_FLUID 128
#define F_FLUID_MESH 256
#define F_USE_INIT 512
#define F_USE_FINAL 1024
#define F_USE_GT 2048
#define F_USE_FPHASE 4096
#define F_USE_FAD 8192
#define F_DEVO (F_USE_INIT | F_USE_FINAL | F_USE_GT | F_USE_FPHASE | F_USE_FAD)
#define F_NEEDLE 16384
#define F_FALLING 32768
#define F_NDBV 65536
#define F_WINDOW 131072
#define F_BALLISTIC 262144
#define F_TRACE (F_NDBV | F_WINDOW | F_BALLISTIC)
#define F_FEAT (F_NEEDLE | F_FALLING | F_TRACE)
#define F_NONLINEAR (1 << 19)
#define F_MDL (1 << 20)
#define F_PLASTIC (1 << 21)
#define F_EQUIL (1 << 22)
#define F_MAXVEL (1 << 23)
#define F_BC (1 << 24)
#define F_COMPACT (1 << 25)
#define F_MAT (F_NONLINEAR | F_MDL | F_PLASTIC | F_EQUIL | F_MAXVEL | F_BC | F_COMPACT)
#define F_VOL (1 << 26)  // volume effects: the material instance's VOL kernel
#define MAX_WIN 12  // window ring slots (ops/fused_rollout.py MAX_KERNEL_WINDOW)
#define MAX_SRC 3

// variants of the step (template parameter of k1_steps)
#define V_LAND 0
#define V_FLUID_FACE 1
#define V_FLUID_MESH 2
#define V_DEVO 3

__host__ __device__ inline int variant_of(int flags) {
    if (flags & F_FLUID) return (flags & F_FLUID_MESH) ? V_FLUID_MESH : V_FLUID_FACE;
    return (flags & F_DEVO) ? V_DEVO : V_LAND;
}

#define BF 36  // shared floats per voxel for the bond forces

// Floats of K1's per-robot buffer (dynamic shared memory, or a row of the
// device-memory twins' buffer): the bond forces; with contact the contact
// forces (3 a voxel) and the pair pass's staged float4s and tables
// (pair_contact.cuh) over its entries, the S surface voxels for the compact
// pass (n_surf > 0), else the V voxels, the whole rounded up to 16 bytes so
// a twin's rows keep the float4s aligned. ops/fused_rollout.py
// k1_buffer_floats.
__host__ __device__ inline size_t k1_buffer_floats(int V, bool coll, int n_surf) {
    if (!coll) return (size_t)BF * V;
    const int N = n_surf > 0 ? n_surf : V;
    const size_t n = (size_t)(BF + 3) * V + pair_stage_floats(N) + pair_aux_floats(N);
    return (n + 3) & ~(size_t)3;
}

// Whether a K1 launch runs the dense pair pass, and so its DENSE instance
// (k1_steps): contact on a V x V table, not the compact one
static inline bool k1_dense(int flags, bool table) {
    return (flags & F_COLL) && !(flags & F_COMPACT) && table;
}

// ... the compact pass, the material instances' COMPACT instance: contact
// on the compact (S + 1, S) table
static inline bool k1_compact(int flags, bool table) {
    return (flags & F_COLL) && (flags & F_COMPACT) && table;
}

// float32 constants, each rounded on the host from the double the Python
// expression gives (ops/fused_rollout.py _k1_params)
struct Params {
    float L, cs_area, neg_slow, ten_slow, bondz, hbondz, col_damp;
    float sa_w, sish_w, sa_bend, hyst_bend, sa_ext, hyst_ext, sl_thresh;
    float sa_rad, anti, near_eq, sc_value, half_freeze, two_pi_f, freeze;
    float pair_slack;  // 1 + the dense pair pass's cull margin (pair_contact.cuh)
};
#define N_PARAMS 22

struct Q { float w, x, y, z; };
struct F3 { float x, y, z; };

__device__ __forceinline__ float sdiv(float a, float b) { return b != 0.f ? a / b : 0.f; }

__device__ __forceinline__ F3 to_x(int d, F3 v) {
    if (d == 0) return v;
    if (d == 1) return {v.y, -v.x, v.z};
    return {v.z, v.y, -v.x};
}

__device__ __forceinline__ F3 to_orig(int d, F3 v) {
    if (d == 0) return v;
    if (d == 1) return {-v.y, v.x, v.z};
    return {-v.z, v.y, v.x};
}

__device__ __forceinline__ Q qmul(Q a, Q b) {
    return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
            a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
            a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

__device__ __forceinline__ Q qconj(Q q) { return {q.w, -q.x, -q.y, -q.z}; }

__device__ __forceinline__ F3 qrot_inv(Q q, F3 v) {
    const float tw = q.x * v.x + q.y * v.y + q.z * v.z;
    const float tx = q.w * v.x - q.y * v.z + q.z * v.y;
    const float ty = q.w * v.y + q.x * v.z - q.z * v.x;
    const float tz = q.w * v.z - q.x * v.y + q.y * v.x;
    return {tw * q.x + tx * q.w + ty * q.z - tz * q.y,
            tw * q.y - tx * q.z + ty * q.w + tz * q.x,
            tw * q.z + tx * q.y - ty * q.x + tz * q.w};
}

// log map with the reference's acos~sqrt fast path (Vec3D.h:270-283)
__device__ inline F3 q_to_rotvec(Q q, const Params& p) {
    const float sq_len = 1.f - q.w * q.w;
    const float wc = fminf(q.w, 1.f);
    const bool pos = sq_len > 0.f;
    const float inv_sqrt = 1.f / sqrtf(pos ? sq_len : 1.f);
    const bool fast_sel = sq_len < p.sl_thresh;
    float scale;
    if (fast_sel) {
        const float fast_arg = pos ? fmaxf(2.f - 2.f * wc, 0.f) : 1.f;
        scale = 2.f * sqrtf(fast_arg) * inv_sqrt;
    } else {
        const float slow_arg = pos ? fminf(fmaxf(wc, -1.f), 1.f) : 0.f;
        scale = 2.f * acosf(slow_arg) * inv_sqrt;
    }
    if (!pos) scale = 2.f;
    return {q.x * scale, q.y * scale, q.z * scale};
}

// quaternion rotating v onto +X (Vec3D.h:208-238)
__device__ inline Q q_from_angle_to_pos_x(F3 v, const Params& p) {
    const float safe_vx = v.x != 0.f ? v.x : 1.f;
    const float yox = v.y / safe_vx;
    const float zox = v.z / safe_vx;
    const bool small = fabsf(yox) < p.sa_rad && fabsf(zox) < p.sa_rad && v.x != 0.f;
    const float norm2 = v.x * v.x + v.y * v.y + v.z * v.z;
    if (norm2 == 0.f) return {1.f, 0.f, 0.f, 0.f};
    if (small) {
        const float qs_y = 0.5f * zox;
        const float qs_z = -0.5f * yox;
        const float qs_w = 1.f + 0.5f * (-qs_y * qs_y - qs_z * qs_z);
        return {qs_w, 0.f, qs_y, qs_z};
    }
    const float inv_norm = 1.f / sqrtf(norm2);
    const float nx = v.x * inv_norm, ny = v.y * inv_norm, nz = v.z * inv_norm;
    const float theta = acosf(fminf(fmaxf(nx, -1.f), 1.f));
    if (theta > p.anti) return {0.f, 0.f, 1.f, 0.f};
    const float yz2 = nz * nz + ny * ny;
    const float ami = 1.f / sqrtf(yz2 > 0.f ? yz2 : 1.f);
    const float half = 0.5f * theta;
    const float s = sinf(half);
    return {cosf(half), 0.f, nz * ami * s, -ny * ami * s};
}

#ifdef EVOSORO_HOST_EMULATION
__device__ __forceinline__ float warp_min(float v) { return v; }  // one thread a block
__device__ __forceinline__ float warp_max(float v) { return v; }
#else
__device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}
__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}
#endif

// block-wide maximum of one per-thread value, the same in every thread
__device__ inline float block_max1(float v, float* red) {
    v = warp_max(v);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float m = red[0];
    for (int w = 1; w < (int)((blockDim.x + 31) >> 5); ++w) m = fmaxf(m, red[w]);
    __syncthreads();
    return m;
}

// A block-wide sum (and minimum) of three values over the partials of the
// block's first P threads alone (P a multiple of 32, or 1 in the host
// build), folded over P / 32 warps whatever blockDim.x is, the same in
// every thread: K1's step (k1_step.cuh) keeps the partition of voxels to
// partials that its old 256-thread blocks had, so its sums keep their bits
// at any block size. The others' partials are unread.
__device__ inline F3 part_sum3(F3 v, float* red, int P) {
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
    v.z = warp_sum(v.z);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0 && (int)threadIdx.x < P) {
        red[3 * warp] = v.x;
        red[3 * warp + 1] = v.y;
        red[3 * warp + 2] = v.z;
    }
    __syncthreads();
    F3 s = {0.f, 0.f, 0.f};
    for (int w = 0; w < ((P + 31) >> 5); ++w) {
        s.x += red[3 * w];
        s.y += red[3 * w + 1];
        s.z += red[3 * w + 2];
    }
    __syncthreads();
    return s;
}

__device__ inline F3 part_min3(F3 v, float* red, int P) {
    v.x = warp_min(v.x);
    v.y = warp_min(v.y);
    v.z = warp_min(v.z);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0 && (int)threadIdx.x < P) {
        red[3 * warp] = v.x;
        red[3 * warp + 1] = v.y;
        red[3 * warp + 2] = v.z;
    }
    __syncthreads();
    F3 m = {red[0], red[1], red[2]};
    for (int w = 1; w < ((P + 31) >> 5); ++w) {
        m.x = fminf(m.x, red[3 * w]);
        m.y = fminf(m.y, red[3 * w + 1]);
        m.z = fminf(m.z, red[3 * w + 2]);
    }
    __syncthreads();
    return m;
}

// The volume instance's inputs of one robot: its scratch (VOL_SCR floats a
// voxel: the strains of the three bonds it owns, then its transverse sums
// and sections per bond axis) and the float constants of
// ops/fused_rollout.py _vol_params
#define VOL_SCR 9
struct VolArgs {
    float* scr;      // (VOL_SCR, V)
    float dt_frac;   // DtFrac
    float two_pi;    // 2 pi, the reference's truncated pi
    float l2;        // L², rounded from the double product
};

// A side's volume-effects modulus E / ((1 - 2u)(1 + u)) (core/materials.py
// poisson_bond_fields)
__device__ __forceinline__ float side_eh(float e, float u) {
    const float denom = (1.f - 2.f * u) * (1.f + u);
    return denom != 0.f ? e / denom : e;
}

// The material instance's inputs of one robot (ops/fused_rollout.py
// fused_call): its body, its MDL_DATA tables (2P + 3 channels: P strains, P
// stresses, fail strain, last stress, last slope) and BC channels (6 DOF
// bits, external force, prescribed displacement, prescribed rotation
// vector), the surface count of the compact contact pass and the clamp.
struct MatArgs {
    const float* bo;  // (C_B, V)
    const float* ss;  // (2P + 3, V), or null
    const float* bc;  // (15, V), or null
    int n_pts, n_surf;
    float max_disp;   // max_vox_vel_limit * L
};

// Material-model stress at a strain (VX_Object.cpp:1472-1535
// GetModelStress; core/step.py _vox_mat_stress): linear, bilinear with the
// yield kink, or the MDL_DATA point table's segment, read from device
// memory at this voxel (ss: the table's first channel at the voxel).
__device__ __forceinline__ float vox_mat_stress(float strain, float e, float mm, float pm,
                                                float ys, const float* ss, int P, int V) {
    const float linear = e * strain;
    const float ystrain = sdiv(ys, e);
    const float bilinear = strain > ystrain ? ys + pm * (strain - ystrain) : linear;
    float out = mm == 2.f ? bilinear : linear;  // MDL_BILINEAR
    if (ss != nullptr && mm == 3.f) {           // MDL_DATA
        // the first segment whose upper point lies past the strain
        int seg = 0;
        for (int k = 1; k < P - 1; ++k) seg += ss[(size_t)k * V] <= strain ? 1 : 0;
        const float x1 = ss[(size_t)seg * V], x2 = ss[(size_t)(seg + 1) * V];
        const float y1 = ss[(size_t)(P + seg) * V], y2 = ss[(size_t)(P + seg + 1) * V];
        const float fail = ss[(size_t)(2 * P) * V];
        const float interp = y1 + sdiv(strain - x1, x2 - x1) * (y2 - y1);
        const float past = ss[(size_t)(2 * P + 1) * V] + ss[(size_t)(2 * P + 2) * V] * (strain - fail);
        out = strain < fail ? interp : past;
    }
    return out;
}

// The slope d(stress)/d(strain) of vox_mat_stress's linear and bilinear
// curves, the branch torch autograd differentiates through core/step.py's
// _vox_mat_stress: the plastic modulus past a bilinear material's yield
// strain, else the elastic one. (MDL_DATA has none here: B4 refuses it.)
__device__ __forceinline__ float vox_mat_slope(float strain, float e, float mm, float pm,
                                               float ys) {
    return (mm == 2.f && strain > sdiv(ys, e)) ? pm : e;
}

// The axial stress of bond (v, n) between voxels of any material model:
// the per-side stress with the reference's 3-iteration stress-equalization
// loop (VXS_BondInternal.cpp:237-253), or one side's curve on a homogeneous
// bond. SLOPE (B4's material instance only): *dsde receives the stress's
// derivative with respect to the strain, from one tangent carried forward
// beside the loop's sv1, sv2, s1 and s2, by torch autograd's conventions on
// the plain version: a selection passes to its chosen branch only and
// nothing to the convergence test, sdiv's guard cuts where the plain
// version's does, a homogeneous bond takes one side's curve. SIDES (the
// facet drag's instances): sides receives the per-side strains the loop
// ends on, sv1 and sv2 (the bond strain on a homogeneous bond: _bond_dir's
// sv1k, sv2k, :541-545), and with SLOPE their derivatives with respect to
// the strain.
template <bool SLOPE = false, bool SIDES = false>
__device__ inline float nonlinear_stress(const MatArgs& ma, int v, int n, int V, float strain,
                                         bool hom, const Params& p, float* dsde = nullptr,
                                         float* sides = nullptr) {
    const float* bo = ma.bo;
    const float e1 = bo[(size_t)B_EMOD * V + v], e2 = bo[(size_t)B_EMOD * V + n];
    const float mm1 = bo[(size_t)B_MATMODEL * V + v], mm2 = bo[(size_t)B_MATMODEL * V + n];
    const float pm1 = bo[(size_t)B_PLASTIC * V + v], pm2 = bo[(size_t)B_PLASTIC * V + n];
    const float ys1 = bo[(size_t)B_YIELD * V + v], ys2 = bo[(size_t)B_YIELD * V + n];
    const float* ss1 = ma.ss ? ma.ss + v : nullptr;
    const float* ss2 = ma.ss ? ma.ss + n : nullptr;
    const int P = ma.n_pts;
    if (hom) {
        if constexpr (SLOPE) *dsde = vox_mat_slope(strain, e1, mm1, pm1, ys1);
        if constexpr (SIDES) {
            sides[0] = strain;
            sides[1] = strain;
            sides[2] = 1.f;
            sides[3] = 1.f;
        }
        return vox_mat_stress(strain, e1, mm1, pm1, ys1, ss1, P, V);
    }
    float sv1 = strain, sv2 = strain;
    float s1 = vox_mat_stress(sv1, e1, mm1, pm1, ys1, ss1, P, V);
    float s2 = vox_mat_stress(sv2, e2, mm2, pm2, ys2, ss2, P, V);
    // (SLOPE) d/d(strain) of sv1, sv2, s1, s2
    float dv1 = 1.f, dv2 = 1.f, ds1 = 0.f, ds2 = 0.f;
    if constexpr (SLOPE) {
        ds1 = vox_mat_slope(sv1, e1, mm1, pm1, ys1);
        ds2 = vox_mat_slope(sv2, e2, mm2, pm2, ys2);
    }
    for (int it = 0; it < 3; ++it) {
        const float ssum = s1 + s2;
        if (!(fabsf(s1 - s2) <= p.near_eq * fabsf(ssum))) {
            const float n1 = 2.f * sdiv(s2, ssum) * sv1;
            const float n2 = 2.f * sdiv(s1, ssum) * sv2;
            if constexpr (SLOPE) {
                // d(a / ssum) = (da - (a / ssum) dssum) / ssum, 0 where ssum is
                const float dsum = ds1 + ds2;
                const float r1 = sdiv(s1, ssum), r2 = sdiv(s2, ssum);
                const float dr1 = sdiv(ds1 - r1 * dsum, ssum);
                const float dr2 = sdiv(ds2 - r2 * dsum, ssum);
                const float nd1 = 2.f * (dr2 * sv1 + r2 * dv1);
                const float nd2 = 2.f * (dr1 * sv2 + r1 * dv2);
                dv1 = nd1;
                dv2 = nd2;
            }
            sv1 = n1;
            sv2 = n2;
        }
        s1 = vox_mat_stress(sv1, e1, mm1, pm1, ys1, ss1, P, V);
        s2 = vox_mat_stress(sv2, e2, mm2, pm2, ys2, ss2, P, V);
        if constexpr (SLOPE) {
            ds1 = vox_mat_slope(sv1, e1, mm1, pm1, ys1) * dv1;
            ds2 = vox_mat_slope(sv2, e2, mm2, pm2, ys2) * dv2;
        }
    }
    if constexpr (SLOPE) *dsde = 0.5f * (ds1 + ds2);
    if constexpr (SIDES) {
        sides[0] = sv1;
        sides[1] = sv2;
        sides[2] = dv1;
        sides[3] = dv2;
    }
    return 0.5f * (s1 + s2);
}

// One bond (v, d) in its own frame: everything core/step.py's
// _bond_axis_forces computes before the rotation back to the world frame.
// The reverse sweep reads the intermediates; the forward pass only the
// forces, the frame and the memory.
struct Bond {
    F3 rel, ar;            // lattice-rotated p2 - p1, and the same in q1's frame
    Q q1, q2, na2;         // lattice-rotated quaternions, relative rotation
    Q p2ar, totrot, tq2;   // large-angle frame (p2ar, tq2 unset when small)
    float nom_dist, length, strain, stiff;  // stiff: d stress / d strain
    bool small, changed, damped;
    F3 pos2, ra1, ra2;     // the bond's strain state
    F3 lp2, la1, la2;      // the damping memory it was read with
    F3 f1, f2, m1, m2;     // bond-frame forces and moments, damped
};

// si: the robot's state slot; bd: body channel D_MASK of direction d at
// voxel v; n = v + stride_d. MAT (the material instance): the stress comes
// from the material models with `flags & F_NONLINEAR`, and with
// `flags & F_PLASTIC` from plasticity's memory, whose new strain offset
// goes to *soff. VOL (volume effects, with MAT): the Poisson-coupled
// stress in their place, before plasticity, and the thermal term at the
// clock vt = {t, temperature amplitude, period} after it; vo receives the
// bond's Eh and CSavg. SLOPE (with MAT, B4's material instance): with
// `flags & F_NONLINEAR` the bond's stiff is the nonlinear stress's slope at
// its strain, which the reverse sweep reads. VARIANT (with MAT): the step's
// variant. Under V_FLUID_MESH, with `flags & F_NONLINEAR`, sides receives
// the stress equalization's per-side strains, with SLOPE their slopes
// (nonlinear_stress). In a fluid the volume effects' thermal term is on
// with temp_enabled alone: a temperature that does not vary gives each
// side dT = the amplitude (core/step.py _thermal_stress; on land and with
// development the host refuses a fixed temperature).
template <bool MAT = false, bool VOL = false, bool SLOPE = false, int VARIANT = V_LAND>
__device__ inline Bond bond_forward(const float* si, const float* bd, int v, int n,
                                    int d, int V, const Params& p, float dt,
                                    float dt_inv, const MatArgs* ma = nullptr, int flags = 0,
                                    float* soff = nullptr, const float* vt = nullptr,
                                    float* vo = nullptr, float* sides = nullptr) {
#define SIN(k) (si + (size_t)(k) * V)
    Bond o;
    const F3 p1 = {SIN(S_POS + 0)[v], SIN(S_POS + 1)[v], SIN(S_POS + 2)[v]};
    const F3 p2 = {SIN(S_POS + 0)[n], SIN(S_POS + 1)[n], SIN(S_POS + 2)[n]};
    const Q qa = {SIN(S_QUAT)[v], SIN(S_QUAT + 1)[v], SIN(S_QUAT + 2)[v], SIN(S_QUAT + 3)[v]};
    const Q qb = {SIN(S_QUAT)[n], SIN(S_QUAT + 1)[n], SIN(S_QUAT + 2)[n], SIN(S_QUAT + 3)[n]};
    const F3 rel = to_x(d, {p2.x - p1.x, p2.y - p1.y, p2.z - p1.z});
    const F3 qa3 = to_x(d, {qa.x, qa.y, qa.z});
    const F3 qb3 = to_x(d, {qb.x, qb.y, qb.z});
    const Q q1 = {qa.w, qa3.x, qa3.y, qa3.z};
    const Q q2 = {qb.w, qb3.x, qb3.y, qb3.z};
    const F3 ang1_rel = qrot_inv(q1, rel);
    const Q new_ang2 = qmul(qconj(q1), q2);
    // under volume effects the rest length is the lattice's
    const float nom_dist = VOL ? p.L : (SIN(S_SCALE)[v] + SIN(S_SCALE)[n]) * 0.5f;
    const float rx = ang1_rel.x, ry = ang1_rel.y, rz = ang1_rel.z;
    const float small_turn = sdiv(fabsf(rz) + fabsf(ry), rx);
    const float extend_perc = sdiv(rx, nom_dist);
    const bool sa_prev = SIN(S_SMALL + d)[v] > 0.5f;
    const bool go_small = !sa_prev && new_ang2.w > p.sa_w &&
                          small_turn < p.sa_bend && extend_perc < p.sa_ext;
    const bool go_large = sa_prev && (!(new_ang2.w > p.sish_w) ||
                                      small_turn > p.hyst_bend ||
                                      extend_perc > p.hyst_ext);
    const bool small = go_small ? true : (go_large ? false : sa_prev);
    const bool changed = go_small || go_large;
    o.rel = rel; o.ar = ang1_rel; o.q1 = q1; o.q2 = q2; o.na2 = new_ang2;
    o.nom_dist = nom_dist; o.small = small; o.changed = changed;

    F3 pos2, ra1, ra2;
    Q totrot;
    if (small) {  // small-angle frame (VXS_BondInternal.cpp:87-100)
        ra2 = q_to_rotvec(new_ang2, p);
        pos2 = {rx - nom_dist, ry, rz};
        totrot = qconj(q1);
        ra1 = {0.f, 0.f, 0.f};
        o.length = 0.f;
    } else {  // large-angle frame (:101-118)
        const Q p2ar = q_from_angle_to_pos_x(ang1_rel, p);
        totrot = qmul(p2ar, qconj(q1));
        const float sq = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z;
        const float length = sq > 0.f ? sqrtf(sq) : 0.f;
        pos2 = {length - nom_dist, 0.f, 0.f};
        ra1 = q_to_rotvec(p2ar, p);
        const Q tq2 = qmul(totrot, q2);
        ra2 = q_to_rotvec(tq2, p);
        o.p2ar = p2ar; o.tq2 = tq2; o.length = length;
    }
    o.totrot = totrot; o.pos2 = pos2; o.ra1 = ra1; o.ra2 = ra2;

    // axial strain, linear two-material stress (:189-307)
    const float strain = pos2.x / p.L;
    const float E1 = bd[(size_t)D_E1 * V], E2 = bd[(size_t)D_E2 * V];
    const float E = bd[(size_t)D_E * V];
    const float s_sum = E1 + E2;
    const bool near_equal = fabsf(E1 - E2) <= p.near_eq * fabsf(s_sum);
    const bool hom = (bd[(size_t)D_HOM * V] > 0.5f) || near_equal;
    o.stiff = hom ? 0.5f * s_sum : E;
    float stress = o.stiff * strain;
    if constexpr (MAT) {
        if constexpr (VOL) {
            // Eh (1 - u) e + Eh u TSavg (VXS_BondInternal.cpp:200-222)
            const float u1 = ma->bo[(size_t)B_POISSON * V + v];
            const float u2 = ma->bo[(size_t)B_POISSON * V + n];
            const float us = u1 + u2;
            const float u = us != 0.f ? 2.f * (u1 * u2 / us) : 0.f;
            const float e1h = side_eh(E1, u1), e2h = side_eh(E2, u2);
            const float es = e1h + e2h;
            const float eh = es != 0.f ? 2.f * (e1h * e2h / es) : 0.f;
            stress = eh * (1.f - u) * strain + eh * u * SIN(S_TSAVG + d)[v];
            vo[0] = eh;
            vo[1] = SIN(S_CSAVG + d)[v];
        } else if (flags & F_NONLINEAR) {  // no near-equal widening on this path
            constexpr bool SIDES = VARIANT == V_FLUID_MESH;
            if constexpr (SLOPE)
                stress = nonlinear_stress<true, SIDES>(
                    *ma, v, n, V, strain, bd[(size_t)D_HOM * V] > 0.5f, p, &o.stiff, sides);
            else if constexpr (SIDES)
                stress = nonlinear_stress<false, true>(
                    *ma, v, n, V, strain, bd[(size_t)D_HOM * V] > 0.5f, p, nullptr, sides);
            else
                stress = nonlinear_stress(*ma, v, n, V, strain, bd[(size_t)D_HOM * V] > 0.5f, p);
        }
        if (flags & F_PLASTIC) {
            // new-territory strains follow the curve; inside it the stress
            // unloads linearly from the strain offset (:193-207)
            const float so = SIN(S_SOFF + d)[v];
            const float ms = SIN(S_MAXS + d)[v];
            const bool fresh = strain >= ms;
            if (!fresh) stress = E * (strain - so);
            *soff = fresh ? fmaxf(ms, strain) - sdiv(stress, E) : so;
        }
        if constexpr (VOL && (VARIANT == V_FLUID_FACE || VARIANT == V_FLUID_MESH)) {
            if (flags & F_TEMP_ENABLED) {
                // less the sides' mean E CTE dT / (1 - 2u), dT from each
                // material's temperature sinusoid, or the amplitude where
                // the temperature does not vary (:284-298)
                const float* bo = ma->bo;
                float dT1 = vt[1], dT2 = vt[1];
                if (flags & F_TEMP) {
                    const float tper = vt[2];
                    const float w = p.two_pi_f * vt[0] * sdiv(1.f, tper);
                    dT1 = tper != 0.f ? vt[1] * sinf(w + bo[(size_t)B_MTPHASE * V + v]) : 0.f;
                    dT2 = tper != 0.f ? vt[1] * sinf(w + bo[(size_t)B_MTPHASE * V + n]) : 0.f;
                }
                const float s1t = sdiv(bo[(size_t)B_EMOD * V + v] * bo[(size_t)B_CTE * V + v] * dT1,
                                       1.f - 2.f * bo[(size_t)B_POISSON * V + v]);
                const float s2t = sdiv(bo[(size_t)B_EMOD * V + n] * bo[(size_t)B_CTE * V + n] * dT2,
                                       1.f - 2.f * bo[(size_t)B_POISSON * V + n]);
                stress = stress - 0.5f * (s1t + s2t);
            }
        } else if constexpr (VOL) {
            if (flags & F_TEMP) {
                // less the sides' mean E CTE dT / (1 - 2u), dT from each
                // material's temperature sinusoid (:284-298)
                const float* bo = ma->bo;
                const float tper = vt[2];
                const float w = p.two_pi_f * vt[0] * sdiv(1.f, tper);
                const float dT1 = tper != 0.f ? vt[1] * sinf(w + bo[(size_t)B_MTPHASE * V + v]) : 0.f;
                const float dT2 = tper != 0.f ? vt[1] * sinf(w + bo[(size_t)B_MTPHASE * V + n]) : 0.f;
                const float s1t = sdiv(bo[(size_t)B_EMOD * V + v] * bo[(size_t)B_CTE * V + v] * dT1,
                                       1.f - 2.f * bo[(size_t)B_POISSON * V + v]);
                const float s2t = sdiv(bo[(size_t)B_EMOD * V + n] * bo[(size_t)B_CTE * V + n] * dT2,
                                       1.f - 2.f * bo[(size_t)B_POISSON * V + n]);
                stress = stress - 0.5f * (s1t + s2t);
            }
        }
    }
    o.strain = strain;

    // beam forces/moments, bond frame (:122-154); the axial force acts on
    // L² or, under volume effects, on the sides' mean cross-section (:127)
    float area = p.cs_area;
    if constexpr (VOL) area = vo[1];
    const float a2c = bd[(size_t)D_A2 * V], b1 = bd[(size_t)D_B1 * V];
    const float b2 = bd[(size_t)D_B2 * V], b3 = bd[(size_t)D_B3 * V];
    F3 f1 = {stress * area, b1 * pos2.y - b2 * (ra1.z + ra2.z),
             b1 * pos2.z + b2 * (ra1.y + ra2.y)};
    F3 f2 = {-f1.x, -f1.y, -f1.z};
    F3 m1 = {a2c * (ra1.x - ra2.x), b2 * pos2.z + b3 * (2.f * ra1.y + ra2.y),
             -b2 * pos2.y + b3 * (2.f * ra1.z + ra2.z)};
    F3 m2 = {a2c * (ra2.x - ra1.x), b2 * pos2.z + b3 * (ra1.y + 2.f * ra2.y),
             -b2 * pos2.y + b3 * (ra1.z + 2.f * ra2.z)};

    // critical damping from the frame-state memory (:310-346)
    const float* lp2p = SIN(S_LP2 + 3 * d) + v;
    const float* la1p = SIN(S_LA1 + 3 * d) + v;
    const float* la2p = SIN(S_LA2 + 3 * d) + v;
    const F3 lp2 = {lp2p[0], lp2p[V], lp2p[2 * V]};
    const F3 la1 = {la1p[0], la1p[V], la1p[2 * V]};
    const F3 la2 = {la2p[0], la2p[V], la2p[2 * V]};
    o.lp2 = lp2; o.la1 = la1; o.la2 = la2;
    o.damped = !changed && dt > 0.f;
    if (o.damped) {
        const float rvx = (pos2.x - lp2.x) * dt_inv;
        const float rvy = (pos2.y - lp2.y) * dt_inv;
        const float rvz = (pos2.z - lp2.z) * dt_inv;
        const F3 rav1 = {(ra1.x - la1.x) * dt_inv, (ra1.y - la1.y) * dt_inv,
                         (ra1.z - la1.z) * dt_inv};
        const F3 rav2 = {(ra2.x - la2.x) * dt_inv, (ra2.y - la2.y) * dt_inv,
                         (ra2.z - la2.z) * dt_inv};
        const float sum_avz = rav1.z + rav2.z;
        const float sum_avy = rav1.y + rav2.y;
        const float da1m1 = bd[(size_t)D_DA1M1 * V], da1m2 = bd[(size_t)D_DA1M2 * V];
        const float da2i1 = bd[(size_t)D_DA2I1 * V], da2i2 = bd[(size_t)D_DA2I2 * V];
        const float db1m1 = bd[(size_t)D_DB1M1 * V], db1m2 = bd[(size_t)D_DB1M2 * V];
        const float db2fm1 = bd[(size_t)D_DB2FM1 * V], db2fm2 = bd[(size_t)D_DB2FM2 * V];
        const float db3i1 = bd[(size_t)D_DB3I1 * V], db3i2 = bd[(size_t)D_DB3I2 * V];
        f1.x = f1.x + p.bondz * (da1m1 * rvx);
        f1.y = f1.y + p.bondz * (db1m1 * rvy - db2fm1 * sum_avz);
        f1.z = f1.z + p.bondz * (db1m1 * rvz + db2fm1 * sum_avy);
        f2.x = f2.x + p.bondz * (-da1m2 * rvx);
        f2.y = f2.y + p.bondz * (-db1m2 * rvy + db2fm2 * sum_avz);
        f2.z = f2.z + p.bondz * (-db1m2 * rvz - db2fm2 * sum_avy);
        const float davx = rav2.x - rav1.x;
        m1.x = m1.x + p.hbondz * (-da2i1 * davx);
        m1.y = m1.y + p.hbondz * (db2fm1 * rvz + db3i1 * (2.f * rav1.y + rav2.y));
        m1.z = m1.z + p.hbondz * (-db2fm1 * rvy + db3i1 * (2.f * rav1.z + rav2.z));
        m2.x = m2.x + p.hbondz * (da2i2 * davx);
        m2.y = m2.y + p.hbondz * (db2fm2 * rvz + db3i2 * (rav1.y + 2.f * rav2.y));
        m2.z = m2.z + p.hbondz * (-db2fm2 * rvy + db3i2 * (rav1.z + 2.f * rav2.z));
    }
    o.f1 = f1; o.f2 = f2; o.m1 = m1; o.m2 = m2;
    return o;
#undef SIN
}

// A voxel's force and moment sums before gravity, drag and the floor, as
// phase B of k1_steps takes them (the facet-drag variant sums them a
// barrier earlier, in phase B1): slow damping, its own side of its three
// bonds and the far side of the three bonds below it (VXS_Voxel.cpp:482-651,
// :653-675), then the contact force.
// bf: [36][V] bond forces of the step; fc: [3][V] contact forces, read only
// with `coll`. The sums leave through references and `coll` stays a flag:
// with output pointers and a null `fc` nvcc 12.8 allots the land step 112
// registers where it had 120, and the step ran 1.4 % slower on an H100.
__device__ __forceinline__ void force_sum(const float* bf, const float* fc, bool coll, int v,
                                          const int coord[3], const int strides[3], int V,
                                          const F3& vel, float tsm, const Params& p, F3& tf,
                                          F3& tm) {
    tf = {p.neg_slow * vel.x * tsm, p.neg_slow * vel.y * tsm, p.neg_slow * vel.z * tsm};
    tm = {0.f, 0.f, 0.f};
    for (int d = 0; d < 3; ++d) {
        const float* own = bf + (size_t)d * 12 * V + v;
        F3 f2n = {0.f, 0.f, 0.f}, m2n = {0.f, 0.f, 0.f};
        if (coord[d] > 0) {
            const float* nb = bf + (size_t)d * 12 * V + (v - strides[d]);
            f2n = {nb[(size_t)6 * V], nb[(size_t)7 * V], nb[(size_t)8 * V]};
            m2n = {nb[(size_t)9 * V], nb[(size_t)10 * V], nb[(size_t)11 * V]};
        }
        tf.x = tf.x + own[0] + f2n.x;
        tf.y = tf.y + own[(size_t)V] + f2n.y;
        tf.z = tf.z + own[(size_t)2 * V] + f2n.z;
        tm.x = tm.x - own[(size_t)3 * V] - m2n.x;
        tm.y = tm.y - own[(size_t)4 * V] - m2n.y;
        tm.z = tm.z - own[(size_t)5 * V] - m2n.z;
    }
    if (coll) {
        tf.x = tf.x + fc[v];
        tf.y = tf.y + fc[V + v];
        tf.z = tf.z + fc[2 * V + v];
    }
}

// What a voxel's floor contact decides from the state it starts a step
// with (VXS_Voxel.cpp:677-758); the static-friction test also needs the
// force sum, so it is not here.
struct Floor {
    bool contact, stick, stopped, moving, keeps_moving;
    float pen, normal_force, dyn_fric, surface_vel, inv_sv;
};

// vel: the voxel's velocity before the sticky floor zeroes it
__device__ __forceinline__ Floor floor_state(float scale, float pos_z, F3 vel,
                                             float lin_stiff, float ud, float mass,
                                             float dt, int flags) {
    Floor f;
    float pen = 0.5f * scale - pos_z;
    pen = pen > 0.f ? pen : 0.f;
    f.pen = pen;
    f.contact = pen > 0.f;
    f.normal_force = lin_stiff * pen;
    f.stick = (flags & F_STICKY) && f.contact;
    if (f.stick) { vel.x = 0.f; vel.y = 0.f; }
    f.stopped = vel.x == 0.f && vel.y == 0.f;
    const float sv2 = vel.x * vel.x + vel.y * vel.y;
    f.surface_vel = sv2 > 0.f ? sqrtf(sv2) : 0.f;
    f.dyn_fric = ud * f.normal_force;
    f.moving = f.contact && !f.stopped;
    f.keeps_moving = f.dyn_fric * dt < mass * f.surface_vel;
    f.inv_sv = sdiv(1.f, f.surface_vel);
    return f;
}

// The actuation scale of an occupied voxel after the two clamps
// (VXS_Voxel.cpp:224-341); *kept_last says the clamps kept the old scale.
__device__ __forceinline__ float actuation_scale(float t, float scale, float ampdamp,
                                                 float phase, float cte, float tamp,
                                                 float tper, float init_cm, float min_tf,
                                                 float gamp, const Params& p, int flags,
                                                 bool* kept_last) {
    float ctrl = 0.f;
    if (flags & F_TEMP) {
        const float t_over_period = sdiv(t, tper);
        ctrl = ampdamp * (tamp * sinf(p.two_pi_f * (t_over_period + phase))) * cte;
        if (!(t >= init_cm && tper != 0.f)) ctrl = 0.f;
        if (flags & F_FREEZE) {  // FreezeInitialized (:234-256)
            const float middle = 0.5f * (p.sc_value - init_cm);
            const float fs = middle - p.half_freeze;
            if (t > fs && t < middle + p.half_freeze && t < fs + init_cm) ctrl = 0.f;
        }
    }
    const float nom = p.L;
    float curr = ctrl * nom + nom;
    bool kept = false;
    if (curr < scale && curr < min_tf * nom) { curr = scale; kept = true; }
    if (curr > scale && curr > (1.f + gamp) * nom) { curr = scale; kept = true; }
    *kept_last = kept;
    return curr;
}

// The thermal control term of a voxel (VXS_Voxel.cpp:292-305) with the
// FreezeInitialized window, as actuation_scale computes it
__device__ __forceinline__ float thermal_ctrl(float t, float ampdamp, float phase,
                                              float cte, float tamp, float tper,
                                              float init_cm, const Params& p, int flags) {
    float ctrl = 0.f;
    if (flags & F_TEMP) {
        const float t_over_period = sdiv(t, tper);
        ctrl = ampdamp * (tamp * sinf(p.two_pi_f * (t_over_period + phase))) * cte;
        if (!(t >= init_cm && tper != 0.f)) ctrl = 0.f;
        if (flags & F_FREEZE) {
            const float middle = 0.5f * (p.sc_value - init_cm);
            const float fs = middle - p.half_freeze;
            if (t > fs && t < middle + p.half_freeze && t < fs + init_cm) ctrl = 0.f;
        }
    }
    return ctrl;
}

// The scale of an occupied voxel of a development body after the two
// clamps (VXS_Voxel.cpp:224-341): prenatal ramp, growth ramp with the
// mid-life freeze of its clock, final phase offset and amplitude damping,
// size-capped actuation. dv: the body's development channels at this voxel
// (initial size, final size, growth time, start of growth, final phase,
// final damping). *kept_last (B4's adjoint) says the clamps kept the old
// scale.
__device__ __forceinline__ float development_scale(float t, float scale, float ampdamp,
                                                   float phase, float cte,
                                                   const float dv[6], float tamp,
                                                   float tper, float init_cm, float min_tf,
                                                   float gamp, const Params& p, int flags,
                                                   bool* kept_last = nullptr) {
    const float nom = p.L;
    float prenatal = 0.f, dev_temp_fact = 0.f;
    if (flags & F_USE_INIT) {  // prenatal linear ramp (:237-238)
        const float c = t >= 0.5f * init_cm ? 1.f : sdiv(2.f * t, init_cm);
        prenatal = c * (sdiv(dv[0], nom) - 1.f);
    }
    if (flags & (F_USE_GT | F_USE_FINAL)) {  // postnatal development (:263-289)
        // FrozenTimeAdj pauses the development clock inside the freeze window
        const float middle = 0.5f * (p.sc_value - init_cm);
        const float frozen_adj = fminf(fmaxf(t - (middle - p.half_freeze), 0.f), p.freeze);
        const float start = dv[3], growth = dv[2];
        const bool growing = t >= start && growth > 0.f;
        const float eff_t = fminf(t, start + growth + p.freeze) - frozen_adj;
        const float k = growing ? sdiv(eff_t - start, growth) : 0.f;
        if (flags & F_USE_FINAL) dev_temp_fact = k * (sdiv(dv[1], dv[0]) - 1.f);
        if (flags & F_USE_FPHASE) phase = phase + k * (dv[4] - phase);
        if (flags & F_USE_FAD) ampdamp = ampdamp + k * (dv[5] - ampdamp);
    }
    float ctrl = thermal_ctrl(t, ampdamp, phase, cte, tamp, tper, init_cm, p, flags);
    float grown = nom;
    if (flags & (F_USE_INIT | F_USE_FINAL)) {
        float grow_fact = 1.f;
        if (flags & F_USE_INIT) grow_fact = grow_fact * (1.f + prenatal);
        if (flags & F_USE_FINAL) grow_fact = grow_fact * (1.f + dev_temp_fact);
        grown = grow_fact * nom;
        // size-capped actuation (:308-320)
        const float orig_sig = sdiv(sdiv(grown, nom) - 1.f, gamp);
        const float pos_sig = (orig_sig + 1.f) * 0.5f;
        ctrl = ctrl * fminf(pos_sig, 0.5f) * 2.f;
    }
    float curr = ctrl * nom + grown;
    bool kept = false;
    if (curr < scale && curr < min_tf * nom) { curr = scale; kept = true; }
    if (curr > scale && curr > (1.f + gamp) * nom) { curr = scale; kept = true; }
    if (kept_last) *kept_last = kept;
    return curr;
}

// The size development has reached at a voxel, grow_fact * L: what
// development_scale computes on its way (the ballistic rebase starts from it)
__device__ __forceinline__ float development_grown(float t, const float dv[6], float init_cm,
                                                   const Params& p, int flags) {
    const float nom = p.L;
    float prenatal = 0.f, dev_temp_fact = 0.f;
    if (flags & F_USE_INIT) {
        const float c = t >= 0.5f * init_cm ? 1.f : sdiv(2.f * t, init_cm);
        prenatal = c * (sdiv(dv[0], nom) - 1.f);
    }
    if (flags & (F_USE_GT | F_USE_FINAL)) {
        const float middle = 0.5f * (p.sc_value - init_cm);
        const float frozen_adj = fminf(fmaxf(t - (middle - p.half_freeze), 0.f), p.freeze);
        const float start = dv[3], growth = dv[2];
        const bool growing = t >= start && growth > 0.f;
        const float eff_t = fminf(t, start + growth + p.freeze) - frozen_adj;
        const float k = growing ? sdiv(eff_t - start, growth) : 0.f;
        if (flags & F_USE_FINAL) dev_temp_fact = k * (sdiv(dv[1], dv[0]) - 1.f);
    }
    if (!(flags & (F_USE_INIT | F_USE_FINAL))) return nom;
    float grow_fact = 1.f;
    if (flags & F_USE_INIT) grow_fact = grow_fact * (1.f + prenatal);
    if (flags & F_USE_FINAL) grow_fact = grow_fact * (1.f + dev_temp_fact);
    return grow_fact * nom;
}

// The land_water fork's actuation of an occupied voxel in a fluid: no
// development, no amplitude damping, no rate clamps, a hard floor at 0.1
// (land_water VXS_Voxel.cpp:210-236); gated on temp_enabled alone.
__device__ __forceinline__ float fluid_scale(float t, float phase, float cte, float tamp,
                                             float tper, float init_cm, const Params& p,
                                             int flags) {
    float temp_fact = 1.f;
    if (flags & F_TEMP_ENABLED) {
        const float ctrl = tamp * sinf(p.two_pi_f * (sdiv(t, tper) + phase)) * cte;
        temp_fact = 1.f + ((t >= init_cm && tper != 0.f) ? ctrl : 0.f);
    }
    return fmaxf(temp_fact, 0.1f) * p.L;
}

__device__ __forceinline__ F3 qrot(Q q, F3 f) {
    const float tw = f.x * q.x + f.y * q.y + f.z * q.z;
    const float tx = f.x * q.w - f.y * q.z + f.z * q.y;
    const float ty = f.x * q.z + f.y * q.w - f.z * q.x;
    const float tz = -f.x * q.y + f.y * q.x + f.z * q.w;
    return {q.w * tx + q.x * tw + q.y * tz - q.z * ty,
            q.w * ty - q.x * tz + q.y * tw + q.z * tx,
            q.w * tz + q.x * ty - q.y * tx + q.z * tw};
}

// The surface-mesh vertex at the min corner of cell (cx, cy, cz): the mean
// of the coincident corners pos + R (+-L/2 (1 + strain)) of the occupied
// voxels at that cell and its seven -X, -Y, -Z neighbours (GetCurVLoc,
// VX_MeshUtil.cpp:368-421). si: the robot's state; occ: its occupancy
// channel; scr: the bond pass's strains, [d][V] sv1 then [3 + d][V] sv2.
__device__ inline F3 mesh_vertex(const float* si, const float* occ, const float* scr,
                                 int cx, int cy, int cz, int Y, int Z, int V, float half_l) {
    const int c3[3] = {cx, cy, cz};
    const int strides[3] = {Y * Z, Z, 1};
    const int cell = (cx * Y + cy) * Z + cz;
    F3 acc = {0.f, 0.f, 0.f};
    float wsum = 0.f;
    for (int k = 7; k >= 0; --k) {  // the order of the gather tables' slots
        const int e[3] = {(k >> 2) & 1, (k >> 1) & 1, k & 1};
        if (c3[0] < e[0] || c3[1] < e[1] || c3[2] < e[2]) continue;
        const int u = cell - (e[0] * strides[0] + e[1] * strides[1] + e[2] * strides[2]);
        if (!(occ[u] > 0.5f)) continue;
        float off[3];
        for (int a = 0; a < 3; ++a) {
            // the corner looks along +a from voxel u when e[a] is 1: the
            // strain of u's own bond; else the far side of the bond below u
            const int ua = c3[a] - e[a];
            const float strain = e[a] ? scr[(size_t)a * V + u]
                                      : (ua > 0 ? scr[(size_t)(3 + a) * V + u - strides[a]] : 0.f);
            off[a] = (e[a] ? half_l : -half_l) * (1.f + strain);
        }
        const Q qu = {si[(size_t)S_QUAT * V + u], si[(size_t)(S_QUAT + 1) * V + u],
                      si[(size_t)(S_QUAT + 2) * V + u], si[(size_t)(S_QUAT + 3) * V + u]};
        const F3 rw = qrot(qu, {off[0], off[1], off[2]});
        acc.x += si[(size_t)S_POS * V + u] + rw.x;
        acc.y += si[(size_t)(S_POS + 1) * V + u] + rw.y;
        acc.z += si[(size_t)(S_POS + 2) * V + u] + rw.z;
        wsum += 1.f;
    }
    const float w = fmaxf(wsum, 1.f);
    return {acc.x / w, acc.y / w, acc.z / w};
}

// The facet drag on voxel v (occupied, inside the shell): for each exposed
// face two triangles over the 8 vertices around it, each -C A v_n^2 n on
// the voxel's own velocity where the facet faces forward (VX_Sim.cpp:
// 1524-1581). vert: [3][V] vertex field in shared memory; winding as
// envs/drag.py _FACES.
__device__ inline F3 facet_drag(const float* vert, const float* occ, int v,
                                const int coord[3], int X, int Y, int Z, F3 vel,
                                float dragc) {
    const int V = X * Y * Z;
    const int dims[3] = {X, Y, Z};
    const int strides[3] = {Y * Z, Z, 1};
    F3 vt[8];
    for (int k = 0; k < 8; ++k) {
        const int c = v + ((k >> 2) & 1) * strides[0] + ((k >> 1) & 1) * strides[1] + (k & 1);
        vt[k] = {vert[c], vert[V + c], vert[2 * V + c]};
    }
    // corner index k = 4 cx + 2 cy + cz
    const int quads[6][4] = {{4, 6, 7, 5}, {0, 1, 3, 2}, {2, 3, 7, 6},
                             {0, 4, 5, 1}, {1, 5, 7, 3}, {0, 2, 6, 4}};
    F3 sum = {0.f, 0.f, 0.f};
    for (int f = 0; f < 6; ++f) {
        const int a = f >> 1;
        const bool plus = !(f & 1);
        const bool has_nbr = plus ? (coord[a] + 1 < dims[a] && occ[v + strides[a]] > 0.5f)
                                  : (coord[a] > 0 && occ[v - strides[a]] > 0.5f);
        if (has_nbr) continue;
        for (int tri = 0; tri < 2; ++tri) {
            const F3 pa = vt[quads[f][0]];
            const F3 pb = vt[quads[f][1 + tri]];
            const F3 pc = vt[quads[f][2 + tri]];
            const F3 e1 = {pb.x - pa.x, pb.y - pa.y, pb.z - pa.z};
            const F3 e2 = {pc.x - pa.x, pc.y - pa.y, pc.z - pa.z};
            const float nx = e1.y * e2.z - e1.z * e2.y;
            const float ny = e1.z * e2.x - e1.x * e2.z;
            const float nz = e1.x * e2.y - e1.y * e2.x;
            const float n_len = sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
            const float area = 0.5f * n_len;
            const float hx = nx / n_len, hy = ny / n_len, hz = nz / n_len;
            const float vn = vel.x * hx + vel.y * hy + vel.z * hz;
            if (!(vn > 0.f)) continue;  // forward-facing facets only
            const float mag = dragc * area * vn * vn;
            sum.x += -mag * hx;
            sum.y += -mag * hy;
            sum.z += -mag * hz;
        }
    }
    return sum;
}

// The knot of global step i_glob: min(i_glob * K / knot_steps, K - 1)
__device__ __forceinline__ int knot_of(int i_glob, int n_knots, int knot_steps) {
    const long long k = (long long)i_glob * n_knots / knot_steps;
    return k < n_knots - 1 ? (int)k : n_knots - 1;
}

// The per-robot scalars of a launch, read from its stats row
struct Robot {
    float t, dt, dt_inv, inv_m, stop_t, tamp, tper, init_cm, grav, min_tf, gamp, dragc;
    F3 ini;
    bool div, capt;
};

__device__ __forceinline__ Robot load_robot(const float* stat) {
    Robot r;
    r.t = stat[ST_TIME];
    r.div = stat[ST_DIV] > 0.5f;
    r.dt = stat[ST_DT];
    r.ini = {stat[ST_INICM], stat[ST_INICM + 1], stat[ST_INICM + 2]};
    r.capt = stat[ST_CAPT] > 0.5f;
    r.inv_m = stat[ST_INV_MASS];
    r.stop_t = stat[ST_STOP];
    r.tamp = stat[ST_TAMP];
    r.tper = stat[ST_TPER];
    r.init_cm = stat[ST_INITCM];
    r.grav = stat[ST_GRAV];
    r.min_tf = stat[ST_MINTF];
    r.gamp = stat[ST_GAMP];
    r.dragc = stat[ST_DRAGC];
    r.dt_inv = sdiv(1.f, r.dt);
    return r;
}

// The launch constants of the features, each the float32 rounding of the
// double the JAX kernel's Python expression gives (ops/fused_rollout.py
// _feat_params)
struct FeatParams {
    float inv_l;         // 1 / L
    float tb;            // time between traces
    float nexp;          // normalization exponent
    float fs_off;        // middle - freeze / 2: the frozen window opens at fs_off + init_cm
    float fe;            // middle + freeze / 2: ... and closes here
    float win_span;      // n_win * tb
    float two_win;       // 2 * n_win * tb
    float min_growth_t;  // ballistic rebase: min growth time,
    float keep_ratio;    // 1 - max slowdown permitted,
    float bal_slow;      // ballistic slowdown factor
    float src[MAX_SRC][9];  // base xyz, amplitude xyz, 2 pi frequency xyz
    int n_win, n_src, nexp_is_one;
};
#define N_FEAT_FLOATS (10 + 9 * MAX_SRC)
#define N_FEAT_PARAMS (N_FEAT_FLOATS + 3)

// the constants from the host's float array (the counts as floats at its end)
__host__ __device__ inline FeatParams feat_params_from(const float* a) {
    FeatParams f;
    memcpy(&f, a, sizeof(float) * N_FEAT_FLOATS);
    f.n_win = (int)a[N_FEAT_FLOATS];
    f.n_src = (int)a[N_FEAT_FLOATS + 1];
    f.nexp_is_one = (int)a[N_FEAT_FLOATS + 2];
    return f;
}

// A robot's feature carry: stats channels 22-46 in their order
struct Feat {
    float smin[MAX_SRC], ssum[MAX_SRC], scnt;  // per-source min distance, history sums, count
    float fell, pcmy, pvol, nd, ndrg, ndfz, ntr, lasttr, wlast, wprev, wcnt, lastwin;
    float needle[3], ncap, eoly, eolcap;
};
static_assert(sizeof(Feat) == 25 * sizeof(float), "Feat mirrors stats channels 22-46");

__device__ inline Feat load_feat(const float* stat) {
    Feat f;
    memcpy(&f, stat + ST_SRC, sizeof(Feat));
    return f;
}

// the channels the JAX kernel writes: the sources' when it tracks any, the
// rest when a feature bit is on
__device__ inline void store_feat(float* stat, const Feat& f, const FeatParams& fp, int flags) {
    for (int k = 0; k < fp.n_src; ++k) {
        stat[ST_SRC + k] = f.smin[k];
        stat[ST_SRC + 3 + k] = f.ssum[k];
    }
    if (fp.n_src > 0) stat[ST_SRC + 6] = f.scnt;
    if (flags & F_FEAT) memcpy(stat + ST_FEAT, &f.fell, sizeof(float) * (sizeof(Feat) / sizeof(float) - 7));
}

// the window ring: MAX_WIN samples of CoM y, then MAX_WIN of volume
__device__ inline float* feat_ring() {
    __shared__ float ring[2 * MAX_WIN];
    return ring;
}

// dy / ((v1 + v2) / 2)^nexp (VX_SimGA.cpp:58-117)
__device__ __forceinline__ float vol_norm(float dy, float v1, float v2, const FeatParams& fp) {
    const float avg = 0.5f * (v1 + v2);
    const float safe = avg > 0.f ? avg : 1.f;
    return fp.nexp_is_one ? dy / safe : dy / powf(safe, fp.nexp);
}

// The features' bookkeeping at the top of step i, from the state it starts
// from, in the JAX kernel's order: source distances (VX_Sim.cpp:2527-2558,
// a history sample every 50 steps), end-of-life posterior Y (:1078-1082),
// the needle's position at actuation onset (:1084-1088), the fall-over
// latch (:1412-1419). Returns the latch. P: the threads whose partials the
// reductions fold (part_sum3), each over voxels tid, tid + P, ...; by
// default the whole block.
__device__ inline bool feat_top(Feat& fe, const FeatParams& fp, const Params& p,
                                const float* si, const float* bo, int V, int i, int i_glob,
                                float t, float stop_t, float init_cm, int flags, float* red,
                                int P = -1) {
    const int T = P < 0 ? (int)blockDim.x : P;
    const int v0 = (int)threadIdx.x < T ? (int)threadIdx.x : V;  // the others sum nothing
    const float* px = si + (size_t)S_POS * V;
    const float* py = px + V;
    const float* pz = py + V;
    const float* occ = bo + (size_t)B_OCC * V;
    const float* mat = bo + (size_t)B_MAT * V;
    if (fp.n_src > 0) {
        // positions oscillate from actuation onset; distances in lattice units
        const float tau = fmaxf(t - init_cm, 0.f);
        F3 sp[MAX_SRC];
        float m[MAX_SRC];
#pragma unroll
        for (int k = 0; k < MAX_SRC; ++k) {
            const float* c = fp.src[k];
            sp[k] = {0.f, 0.f, 0.f};
            if (k < fp.n_src)
                sp[k] = {c[0] + c[3] * sinf(c[6] * tau), c[1] + c[4] * sinf(c[7] * tau),
                         c[2] + c[5] * sinf(c[8] * tau)};
            m[k] = 3.4e38f;
        }
        for (int v = v0; v < V; v += T) {
            if (!(occ[v] > 0.5f)) continue;
#pragma unroll
            for (int k = 0; k < MAX_SRC; ++k) {
                if (k >= fp.n_src) break;
                const float dx = px[v] - sp[k].x, dy = py[v] - sp[k].y, dz = pz[v] - sp[k].z;
                m[k] = fminf(m[k], dx * dx + dy * dy + dz * dz);
            }
        }
        const F3 mn = part_min3({m[0], m[1], m[2]}, red, T);
        const float mk[MAX_SRC] = {mn.x, mn.y, mn.z};
        const bool hist = i % 50 == 0;  // UPDATE_SOURCES_HIST_EVERY
#pragma unroll
        for (int k = 0; k < MAX_SRC; ++k) {
            if (k >= fp.n_src) break;
            fe.smin[k] = sqrtf(mk[k]) / p.L;
            if (hist) fe.ssum[k] = fe.ssum[k] + fe.smin[k];
        }
        if (hist) fe.scnt = fe.scnt + 1.f;
    }
    if (!(flags & F_FEAT)) return false;
    if (fe.eolcap < 0.5f && t >= stop_t) {
        // min voxel y over non-obstacle voxels, lattice units
        float m = 3.4e38f;
        for (int v = v0; v < V; v += T)
            if (occ[v] > 0.5f && fabsf(mat[v] - 5.f) > 0.5f) m = fminf(m, py[v] * fp.inv_l);
        fe.eoly = part_min3({m, m, m}, red, T).x;
        fe.eolcap = 1.f;
    }
    if (flags & F_NEEDLE) {
        const bool ncapb = fe.ncap < 0.5f && t > init_cm;
        if (ncapb || (i_glob == 0 && fe.ncap < 0.5f)) {
            // masked mean over the mat-7 voxels
            F3 part = {0.f, 0.f, 0.f};
            float n7 = 0.f;
            for (int v = v0; v < V; v += T) {
                const float is7 = fabsf(mat[v] - 7.f) < 0.5f ? 1.f : 0.f;
                part.x += is7 * px[v];
                part.y += is7 * py[v];
                part.z += is7 * pz[v];
                n7 += is7;
            }
            const F3 s = part_sum3(part, red, T);
            const float n = fmaxf(part_sum3({n7, 0.f, 0.f}, red, T).x, 1.f);
            fe.needle[0] = s.x / n;
            fe.needle[1] = s.y / n;
            fe.needle[2] = s.z / n;
        }
        if (ncapb) fe.ncap = 1.f;
    }
    if ((flags & F_FALLING) && t > init_cm) {
        // more mat-6 feet than other voxels touching the floor
        const float* scale = si + (size_t)S_SCALE * V;
        F3 cnt = {0.f, 0.f, 0.f};
        for (int v = v0; v < V; v += T) {
            if (!(0.5f * scale[v] - pz[v] > 0.f && occ[v] > 0.5f)) continue;
            cnt.x += 1.f;
            if (fabsf(mat[v] - 6.f) < 0.5f) cnt.y += 1.f;
        }
        const F3 c = part_sum3(cnt, red, T);
        if (c.y > c.x - c.y) fe.fell = 1.f;
    }
    return (flags & F_FALLING) && fe.fell > 0.5f;
}

// A trace sample is due after the step that ends at t_new (VX_Sim.cpp:
// 1600-1606): past InitCmTime, and the first or tb after the last one
__device__ __forceinline__ bool feat_trace_due(const Feat& fe, const FeatParams& fp,
                                               float t_new, float init_cm) {
    return t_new > init_cm && (fe.ntr < 0.5f || fe.lasttr + fp.tb <= t_new);
}

// The trace bookkeeping after the step that ends at t_new, whose CoM y and
// volume are (cmy, vol) when a sample is `due`: NormDistByVol sums over the
// whole life, the afterlife regime and the frozen window, the ring, and the
// window distance at each window boundary (VX_Sim.cpp:2745-2784). Every
// thread of the block runs it.
__device__ inline void feat_trace(Feat& fe, const FeatParams& fp, const Params& p, float t_new,
                                  bool due, float cmy, float vol, float init_cm, int flags) {
    float* ring = feat_ring();
    if ((flags & F_NDBV) && due && fe.ntr > 0.5f) {
        const float term = vol_norm((cmy - fe.pcmy) * fp.inv_l, vol, fe.pvol, fp);
        fe.nd = fe.nd + term;
        // both samples past the lifetime's end
        if (t_new > p.sc_value && fe.lasttr > p.sc_value) fe.ndrg = fe.ndrg + term;
        if (flags & F_FREEZE) {
            const float fs = fp.fs_off + init_cm;
            if (t_new > fs && t_new < fp.fe && fe.lasttr > fs && fe.lasttr < fp.fe)
                fe.ndfz = fe.ndfz + term;
        }
    }
    if (fp.n_win > 0 && due) {
        if (threadIdx.x == 0) {
            for (int k = 0; k + 1 < fp.n_win; ++k) {
                ring[k] = ring[k + 1];
                ring[MAX_WIN + k] = ring[MAX_WIN + k + 1];
            }
            ring[fp.n_win - 1] = cmy;
            ring[MAX_WIN + fp.n_win - 1] = vol;
        }
        __syncthreads();
    }
    if (due) {
        fe.ntr = fe.ntr + 1.f;
        fe.lasttr = t_new;
        fe.pcmy = cmy;
        fe.pvol = vol;
    }
    if (fp.n_win > 0 && t_new > init_cm &&
        (fe.lastwin < -0.5f || fe.lastwin + fp.win_span <= t_new)) {
        const float valid = fminf(fe.ntr, (float)fp.n_win);
        float wd = 0.f;
        for (int k = 0; k + 1 < fp.n_win; ++k)
            if (valid >= (float)(fp.n_win - k))
                wd = wd + vol_norm((ring[k + 1] - ring[k]) * fp.inv_l, ring[MAX_WIN + k + 1],
                                   ring[MAX_WIN + k], fp);
        fe.wprev = fe.wlast;
        fe.wlast = wd;
        fe.wcnt = fe.wcnt + 1.f;
        fe.lastwin = t_new;
    }
}

// The source history samples of the steps after step i that a frozen robot
// skips (its distances no longer change)
__device__ inline void feat_tail(Feat& fe, const FeatParams& fp, int i, int num_steps) {
    if (fp.n_src == 0) return;
    for (int j = (i / 50 + 1) * 50; j < num_steps; j += 50) {
        for (int k = 0; k < fp.n_src; ++k) fe.ssum[k] = fe.ssum[k] + fe.smin[k];
        fe.scnt = fe.scnt + 1.f;
    }
}

// Ballistic development (VXS_Voxel.cpp:342-381): once two speed windows
// exist, rebase a voxel's development fields dv (initial size, final size,
// growth time, start of growth) at its current size `cur`, pulling the
// final size toward it when the windowed speed fell by more than the
// permitted slowdown; `orig`: the body's final size, the bound.
__device__ inline void ballistic_rebase(float t, const float dv[6], float orig, float cur,
                                        const Feat& fe, const FeatParams& fp, float init_cm,
                                        float out[4]) {
    const bool ready = fe.wcnt >= 1.5f && t >= init_cm + fp.two_win;
    const bool apply = ready && t >= dv[3] + fp.min_growth_t;
    const float this_s = fe.wlast, last_s = fe.wprev;
    const float ratio = sdiv(this_s, last_s != 0.f ? last_s : 1.f);
    const bool decreasing = last_s > 0.f && this_s < last_s && ratio < fp.keep_ratio;
    const float adj = 1.f - (decreasing ? fp.bal_slow : 0.f);
    const float suggested = cur + (dv[1] - cur) * adj;
    float fin;
    if (orig > cur) {
        const float s = fminf(suggested, orig);
        fin = s >= cur ? s : cur;
    } else {
        const float s = fmaxf(suggested, orig);
        fin = s <= cur ? s : cur;
    }
    out[0] = apply ? cur : dv[0];
    out[1] = apply ? fin : dv[1];
    out[2] = apply ? fmaxf(dv[2] - (t - dv[3]), 0.f) : dv[2];
    out[3] = apply ? t : dv[3];
}
