// What the forward rollout kernel (fused_rollout.cu, K1) and the reverse-mode
// segment kernel (fused_rollout_bwd.cu, B4) share: the packed channel maps,
// the launch constants, the quaternion helpers, one bond's forward pass
// (bond_forward) and the block-wide step loop (rollout_steps).
//
// rollout_steps reads step i's state from slot i of a buffer and writes the
// new state to slot i + 1, `slot_stride` floats further on. K1 passes a
// stride of 0, so the state is updated in place as before; B4 passes a tape
// in device memory, so the forward recompute of a segment leaves the state
// every step started from, which is what the reverse sweep needs.
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
#define S_DIFF 47  // channels [0, S_DIFF) carry the rollout; the rest are unused here
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

// feature flags (host: ops/fused_rollout.py _K1_FLAG_BITS)
#define F_FLOOR 1
#define F_STICKY 2
#define F_GRAVITY 4
#define F_TEMP 8
#define F_FREEZE 16
#define F_COLL 32

#define MAX_THREADS 256
#define BF 36  // shared floats per voxel for the bond forces

// float32 constants, each rounded on the host from the double the Python
// expression gives (ops/fused_rollout.py _k1_params)
struct Params {
    float L, cs_area, neg_slow, ten_slow, bondz, hbondz, col_damp;
    float sa_w, sish_w, sa_bend, hyst_bend, sa_ext, hyst_ext, sl_thresh;
    float sa_rad, anti, near_eq, sc_value, half_freeze, two_pi_f;
};
#define N_PARAMS 20

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

// block-wide sum of three per-thread partials, the same value in every thread
__device__ inline F3 block_sum3(F3 v, float* red) {
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
    v.z = warp_sum(v.z);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        red[3 * warp] = v.x;
        red[3 * warp + 1] = v.y;
        red[3 * warp + 2] = v.z;
    }
    __syncthreads();
    F3 s = {0.f, 0.f, 0.f};
    for (int w = 0; w < (int)((blockDim.x + 31) >> 5); ++w) {
        s.x += red[3 * w];
        s.y += red[3 * w + 1];
        s.z += red[3 * w + 2];
    }
    __syncthreads();
    return s;
}

// One bond (v, d) in its own frame: everything core/step.py's
// _bond_axis_forces computes before the rotation back to the world frame.
// The reverse sweep reads the intermediates; the forward pass only the
// forces, the frame and the memory.
struct Bond {
    F3 rel, ar;            // lattice-rotated p2 - p1, and the same in q1's frame
    Q q1, q2, na2;         // lattice-rotated quaternions, relative rotation
    Q p2ar, totrot, tq2;   // large-angle frame (p2ar, tq2 unset when small)
    float nom_dist, length, strain, stiff;  // stress = stiff * strain
    bool small, changed, damped;
    F3 pos2, ra1, ra2;     // the bond's strain state
    F3 lp2, la1, la2;      // the damping memory it was read with
    F3 f1, f2, m1, m2;     // bond-frame forces and moments, damped
};

// si: the robot's state slot; bd: body channel D_MASK of direction d at
// voxel v; n = v + stride_d.
__device__ inline Bond bond_forward(const float* si, const float* bd, int v, int n,
                                    int d, int V, const Params& p, float dt,
                                    float dt_inv) {
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
    const float nom_dist = (SIN(S_SCALE)[v] + SIN(S_SCALE)[n]) * 0.5f;
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
    const float stress = o.stiff * strain;
    o.strain = strain;

    // beam forces/moments, bond frame (:122-154)
    const float a2c = bd[(size_t)D_A2 * V], b1 = bd[(size_t)D_B1 * V];
    const float b2 = bd[(size_t)D_B2 * V], b3 = bd[(size_t)D_B3 * V];
    F3 f1 = {stress * p.cs_area, b1 * pos2.y - b2 * (ra1.z + ra2.z),
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

// The knot of global step i_glob: min(i_glob * K / knot_steps, K - 1)
__device__ __forceinline__ int knot_of(int i_glob, int n_knots, int knot_steps) {
    const long long k = (long long)i_glob * n_knots / knot_steps;
    return k < n_knots - 1 ? (int)k : n_knots - 1;
}

// The per-robot scalars of a launch, read from its stats row
struct Robot {
    float t, dt, dt_inv, inv_m, stop_t, tamp, tper, init_cm, grav, min_tf, gamp;
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
    r.dt_inv = sdiv(1.f, r.dt);
    return r;
}

// The step loop of one robot, run by its whole block. Step i reads the
// state at st + i * slot_stride and writes st + (i + 1) * slot_stride
// (slot_stride 0: in place). r carries time, divergence latch, IniCM and the
// capture flag in and out. With a tape (slot_stride > 0) step i also leaves
// its clock in tape_t[i] and each voxel's static-friction decision in
// channel S_DIFF of slot i. Returns the number of steps taken: a robot that
// is frozen (diverged, or past its stop time) leaves the loop, and the
// steps it skips change nothing.
//
// sh: BF * V floats of shared memory (+ 7 * V with collision).
__device__ inline int rollout_steps(float* st, size_t slot_stride, const float* bo,
                                    const float* a1, const float* cu_robot, int n_knots,
                                    int knot_steps, int step_base, int X, int Y, int Z,
                                    int num_steps, const Params& p, int flags, Robot& r,
                                    float* tape_t, float* sh) {
    __shared__ float red[3 * (MAX_THREADS / 32)];
    __shared__ int divflag[2];

    const int V = X * Y * Z;
    const int T = blockDim.x;
    const bool coll = (flags & F_COLL) != 0;
    float* bf = sh;                       // [36][V] bond forces
    float* sp = sh + BF * V;              // [4][V] staged pos/scale
    float* fc = sp + 4 * V;               // [3][V] contact forces
    const int strides[3] = {Y * Z, Z, 1};

    float t = r.t;
    bool div = r.div;
    const float dt = r.dt;
    F3 ini = r.ini;
    bool capt = r.capt;
    const float inv_m = r.inv_m;
    const float stop_t = r.stop_t;
    const float init_cm = r.init_cm;
    const float grav = r.grav;
    const float dt_inv = r.dt_inv;

    if (threadIdx.x < 2) divflag[threadIdx.x] = 0;
    __syncthreads();

#define SCH(k) (si + (size_t)(k) * V)
#define SOUT(k) (so + (size_t)(k) * V)
#define BCH(k) (bo + (size_t)(k) * V)

    int i = 0;
    for (; i < num_steps; ++i) {
        const int i_glob = step_base + i;
        // the state is read and written within the launch: no read-only cache
        const float* si = st + (size_t)i * slot_stride;
        float* so = st + (size_t)(i + 1) * slot_stride;
        // ---- rollout bookkeeping from the previous step's positions ----
        const bool capture = !capt && (t > init_cm);
        const bool take = capture || (i_glob == 0 && !capt);
        if (take) {
            F3 part = {0.f, 0.f, 0.f};
            for (int v = threadIdx.x; v < V; v += T) {
                const float m = BCH(B_MASS)[v];
                part.x += SCH(S_POS + 0)[v] * m;
                part.y += SCH(S_POS + 1)[v] * m;
                part.z += SCH(S_POS + 2)[v] * m;
            }
            const F3 s = block_sum3(part, red);
            ini = {s.x * inv_m, s.y * inv_m, s.z * inv_m};
        }
        capt = capt || capture;
        if (div || t >= stop_t) break;  // frozen: nothing changes any more
        if (tape_t && threadIdx.x == 0) tape_t[i] = t;

        // this step's control knot: a row of the robot's (K, V) controls
        const float* cu = nullptr;
        if (n_knots > 0)
            cu = cu_robot + (size_t)knot_of(i_glob, n_knots, knot_steps) * V;

        // ---- phase A: bond pass (+ staging for the pair pass) ----
        if (coll) {
            for (int v = threadIdx.x; v < V; v += T) {
                sp[v] = SCH(S_POS + 0)[v];
                sp[V + v] = SCH(S_POS + 1)[v];
                sp[2 * V + v] = SCH(S_POS + 2)[v];
                sp[3 * V + v] = SCH(S_SCALE)[v];
            }
            __syncthreads();
            pair_contact_block(sp, a1, V, fc, V, 0, V);
        }
        int diverging = 0;
        for (int v = threadIdx.x; v < V; v += T) {
            for (int d = 0; d < 3; ++d) {
                const float* bd = bo + (size_t)(B_DIR + d * B_PER_DIR) * V + v;
                float* out = bf + (size_t)d * 12 * V + v;
                float* lp2p = SOUT(S_LP2 + 3 * d) + v;
                float* la1p = SOUT(S_LA1 + 3 * d) + v;
                float* la2p = SOUT(S_LA2 + 3 * d) + v;
                if (!(bd[(size_t)D_MASK * V] > 0.5f)) {
                    for (int k = 0; k < 12; ++k) out[(size_t)k * V] = 0.f;
                    for (int c = 0; c < 3; ++c) {
                        lp2p[(size_t)c * V] = 0.f;
                        la1p[(size_t)c * V] = 0.f;
                        la2p[(size_t)c * V] = 0.f;
                    }
                    SOUT(S_MAXS + d)[v] = 0.f;
                    if (slot_stride) SOUT(S_SMALL + d)[v] = SCH(S_SMALL + d)[v];
                    continue;
                }
                const Bond bn = bond_forward(si, bd, v, v + strides[d], d, V, p, dt, dt_inv);
                SOUT(S_MAXS + d)[v] = fmaxf(SCH(S_MAXS + d)[v], bn.strain);
                if (fabsf(bn.strain) > 100.f) diverging = 1;

                // back to the world frame (:159-170)
                const F3 f1 = to_orig(d, qrot_inv(bn.totrot, bn.f1));
                const F3 f2 = to_orig(d, qrot_inv(bn.totrot, bn.f2));
                const F3 m1 = to_orig(d, qrot_inv(bn.totrot, bn.m1));
                const F3 m2 = to_orig(d, qrot_inv(bn.totrot, bn.m2));
                out[0] = f1.x; out[(size_t)V] = f1.y; out[(size_t)2 * V] = f1.z;
                out[(size_t)3 * V] = m1.x; out[(size_t)4 * V] = m1.y; out[(size_t)5 * V] = m1.z;
                out[(size_t)6 * V] = f2.x; out[(size_t)7 * V] = f2.y; out[(size_t)8 * V] = f2.z;
                out[(size_t)9 * V] = m2.x; out[(size_t)10 * V] = m2.y; out[(size_t)11 * V] = m2.z;

                // the damping memory goes stale for one step on a hysteresis
                // transition (AddDampForces is skipped, :344-347)
                if (!bn.changed) {
                    lp2p[0] = bn.pos2.x; lp2p[V] = bn.pos2.y; lp2p[2 * V] = bn.pos2.z;
                    la1p[0] = bn.ra1.x; la1p[V] = bn.ra1.y; la1p[2 * V] = bn.ra1.z;
                    la2p[0] = bn.ra2.x; la2p[V] = bn.ra2.y; la2p[2 * V] = bn.ra2.z;
                } else if (slot_stride) {
                    lp2p[0] = bn.lp2.x; lp2p[V] = bn.lp2.y; lp2p[2 * V] = bn.lp2.z;
                    la1p[0] = bn.la1.x; la1p[V] = bn.la1.y; la1p[2 * V] = bn.la1.z;
                    la2p[0] = bn.la2.x; la2p[V] = bn.la2.y; la2p[2 * V] = bn.la2.z;
                }
                SOUT(S_SMALL + d)[v] = bn.small ? 1.f : 0.f;
            }
        }
        if (diverging) atomicOr(&divflag[i & 1], 1);
        __syncthreads();
        const bool div_now = divflag[i & 1] != 0;

        // ---- phase B: per-voxel force sum and integration ----
        for (int v = threadIdx.x; v < V; v += T) {
            const bool occ = BCH(B_OCC)[v] > 0.5f;
            // loaded first, so the load is in flight during the force sum
            const float u_knot = cu ? __ldg(cu + v) : 0.f;
            const int coord[3] = {v / (Y * Z), (v / Z) % Y, v % Z};
            const float mass = BCH(B_MASS)[v];
            const float minv = BCH(B_MASS_INV)[v];
            const float tsm = BCH(B_2SQ_MEXS)[v];
            F3 lin = {SCH(S_LIN)[v], SCH(S_LIN + 1)[v], SCH(S_LIN + 2)[v]};
            F3 vel = {lin.x * minv, lin.y * minv, lin.z * minv};
            F3 tf = {p.neg_slow * vel.x * tsm, p.neg_slow * vel.y * tsm, p.neg_slow * vel.z * tsm};
            F3 tm = {0.f, 0.f, 0.f};
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
            if (flags & F_GRAVITY) tf.z = tf.z + mass * grav;

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
            if (slot_stride) st[(size_t)i * slot_stride + (size_t)S_DIFF * V + v] =
                static_flag ? 1.f : 0.f;
            if (!occ) { tf = {0.f, 0.f, 0.f}; tm = {0.f, 0.f, 0.f}; }

            // Euler step (VXS_Voxel.cpp:181-197)
            lin = {lin.x + tf.x * dt, lin.y + tf.y * dt, lin.z + tf.z * dt};
            const float dtm = dt * minv;
            pos = {pos.x + lin.x * dtm, pos.y + lin.y * dtm, pos.z + lin.z * dtm};

            // angular integration and quaternion update (:202-215)
            const float iinv = BCH(B_INERTIA_INV)[v];
            const float ang_fact = 1.f - p.ten_slow * iinv * BCH(B_2SQ_IEXSSS)[v] * dt;
            F3 ang = {(SCH(S_ANG)[v] + tm.x * dt) * ang_fact,
                      (SCH(S_ANG + 1)[v] + tm.y * dt) * ang_fact,
                      (SCH(S_ANG + 2)[v] + tm.z * dt) * ang_fact};
            const Q qo = {SCH(S_QUAT)[v], SCH(S_QUAT + 1)[v], SCH(S_QUAT + 2)[v], SCH(S_QUAT + 3)[v]};
            const Q sp4 = qmul({0.f, ang.x * iinv, ang.y * iinv, ang.z * iinv}, qo);
            Q qn = {qo.w + 0.5f * sp4.w * dt, qo.x + 0.5f * sp4.x * dt,
                    qo.y + 0.5f * sp4.y * dt, qo.z + 0.5f * sp4.z * dt};
            const float l2 = qn.w * qn.w + qn.x * qn.x + qn.y * qn.y + qn.z * qn.z;
            const float li = l2 > 0.f ? 1.f / sqrtf(l2) : 1.f;
            qn = {qn.w * li, qn.x * li, qn.y * li, qn.z * li};
            if (qn.w >= 1.f) qn = {1.f, 0.f, 0.f, 0.f};

            if (!occ) {  // keep empty cells inert
                pos = {((float)coord[0] + 0.5f) * p.L, ((float)coord[1] + 0.5f) * p.L,
                       ((float)coord[2] + 0.5f) * p.L};
                lin = {0.f, 0.f, 0.f};
                ang = {0.f, 0.f, 0.f};
            }

            // actuation scale update (VXS_Voxel.cpp:224-341)
            bool kept_last;
            const float curr = actuation_scale(
                t, scale, BCH(B_AMPDAMP)[v], BCH(B_PHASE)[v], BCH(B_CTE)[v], r.tamp,
                r.tper, init_cm, r.min_tf, r.gamp, p, flags, &kept_last);
            const float nom = p.L;

            SOUT(S_POS)[v] = pos.x; SOUT(S_POS + 1)[v] = pos.y; SOUT(S_POS + 2)[v] = pos.z;
            SOUT(S_QUAT)[v] = qn.w; SOUT(S_QUAT + 1)[v] = qn.x;
            SOUT(S_QUAT + 2)[v] = qn.y; SOUT(S_QUAT + 3)[v] = qn.z;
            SOUT(S_LIN)[v] = lin.x; SOUT(S_LIN + 1)[v] = lin.y; SOUT(S_LIN + 2)[v] = lin.z;
            SOUT(S_ANG)[v] = ang.x; SOUT(S_ANG + 1)[v] = ang.y; SOUT(S_ANG + 2)[v] = ang.z;
            float new_scale = occ ? curr : nom;
            // MPC channel, after the clamps: the product and the sum round
            // separately, as core/step.py's control_offset does
            if (cu) new_scale = new_scale + (occ ? u_knot * nom : 0.f);
            SOUT(S_SCALE)[v] = new_scale;
        }
        if (threadIdx.x == 0) divflag[(i + 1) & 1] = 0;
        t = t + dt;
        div = div || div_now;
        __syncthreads();
    }
#undef SCH
#undef SOUT
#undef BCH
    r.t = t;
    r.div = div;
    r.ini = ini;
    r.capt = capt;
    return i;
}
