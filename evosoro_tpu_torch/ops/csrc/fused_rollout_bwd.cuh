// B4: reverse-mode segment of the fused rollout, B robots x num_steps in one
// launch: pull the cotangent of a segment's END state back to the cotangent
// of its START state and of the control knots.
//
// Replaces: evosoro_tpu/ops/fused_rollout.py, _make_kernel(bwd=True) as
// launched by _fused_bwd_call. That kernel recomputes the segment into a
// tape in on-chip memory and gets each step's adjoint from jax.vjp of the
// step closure. Here the adjoint of the step is written out by hand below
// (pass (a) for the integration phase, bond_vjp for the bond pass, with
// the vjp of each quaternion helper), and the tape lies in device memory,
// allocated by the host wrapper: (B, num_steps + 1, 48, V) floats (54 with
// the facet drag, below), slot i holding the 47 carried channels of the
// state step i starts from plus that step's static-friction decisions; at
// the widths gradient MPC uses the tape of a launch fits the card's L2.
//
// A robot runs on a thread-block cluster of C blocks (b4_planes: up to 8,
// as many as let the card hold the whole batch at once, else one block),
// block k owning a run of x-planes and the bonds whose lower end lies in
// them. The cluster
//   1. recomputes the segment forward on its first block (rank 0) with
//      K1's own step loop in its tape form (b4_recompute: k1_steps<...,
//      TAPE>, one slot a step, out of place), so every predicate below is
//      decided on the very values the forward launch saw; the other blocks
//      wait at a cluster barrier;
//   2. walks the steps back. Per step: (a) each voxel's thread pulls the
//      new state's cotangent through the integration phase, which gives the
//      cotangent of the voxel's force and moment sums; a barrier; (b) each
//      bond item (v, d), a thread each and d-major as K1's bond pass, pulls
//      the force cotangents of its two ends and the cotangent of its
//      damping memory through the bond pass (bond_forward again, then
//      bond_vjp); a barrier; (c) each voxel adds what its own three bonds
//      and then what its three lower neighbours' bonds sent it.
// The scatter is in gather form, like K1's force sum: a bond leaves the
// cotangents of its own voxel and of its other end (position, quaternion,
// scale: 8 floats each) in its block's slab, a row a direction (48 floats a
// voxel), beside the voxel's force and moment cotangents (6). Pass (c) sums
// a voxel's own three rows over d from zero and adds the sum at once, then
// the neighbours' rows: the parent's one-thread-a-voxel order, so every bit
// is kept. No atomics: the result does not depend on the schedule. A bond
// along x from a block's last plane reads its far end's cotangents, and the
// voxels of a block's first plane read their lower neighbours' rows, in the
// next and the previous block's slab through distributed shared memory
// (map_shared_rank); cluster barriers take the block barriers' place. A
// slab lives in shared memory (after the recompute's buffer, which it may
// overlay) or, where a block's does not fit, in device memory
// (fused_rollout_bwd.cu b4_shape).
//
// Branch conventions are those of torch autograd on core/step.py, the plain
// version: a selection passes the cotangent to the chosen branch only and
// nothing to its predicate; max(a, b) splits a tie in halves; a clamp
// passes at its bounds; the quaternion identity snap, the guarded square
// roots and divisions cut the cotangent where the plain version's guard
// does; steps a frozen robot skipped are the identity. small_angle, the
// clock, the divergence latch, IniCM and the capture flag carry no
// gradient. Channels 47..63 of the state cotangent come back zero.
//
// Bound on this card: the latency of a step, as K1. The reverse step does
// about twice the arithmetic of the forward one, reads the tape from L2 and
// recomputes each bond's forward pass; bond items put 3 V threads on it,
// and a cluster spreads one robot's sweep over C SMs, where a launch of the
// SQP solve's 8 robots would leave 124 of 132 SMs idle. The recompute stays
// on one block and is K1's time.
//
// Numerics: -fmad=false and no fast math, as K1, so the recompute equals
// K1's forward bit for bit. The adjoint sums in its own order, so it agrees
// with autograd to rounding, not bit for bit; its order does not depend on
// the block size or on C.
//
// reverse_segment is a template over K1's step variant. The fluid and
// development instances add, each under `if constexpr`:
//   V_FLUID_FACE  the voxel-face drag's adjoint (cotangent to the momentum
//                 through the velocity and to the old scale through the
//                 face area scale^2), and the land_water actuation, which
//                 does not read the old scale: the knot's cotangent only;
//   V_FLUID_MESH  the facet drag's adjoint on the deformed surface mesh
//                 (below) with the same actuation;
//   V_DEVO        the development ramps: the clamps' "keep last" branch, as
//                 on land; the clock, the ramps and the freeze carry none.
// They replace evosoro_tpu/ops/fused_rollout.py, _make_kernel(bwd=True)'s
// jax.vjp of the step closure through :1373-1469 and :1610-1705.
//
// The facet drag (V_FLUID_MESH). A voxel's drag reads the 8 mesh vertices
// around it; a vertex is the mean of the coincident corners
// pos + R(q) (+-L/2 (1 + strain)) of the occupied voxels around it, with
// this step's per-side bond strains. The forward recompute tapes those
// strains (6 channels more a slot, NT_MESH) and the reverse sweep adds
// three passes and cluster barriers before the bond pass, through 27
// floats a voxel of device scratch (the slabs stay the land variant's):
//   (a0) each cell rebuilds its vertex from the tape (mesh_vertex, as K1);
//   (a)  besides the integration phase, each voxel pulls its force's
//        cotangent through its 12 facets (facet_drag_vjp) to its velocity
//        and to its 8 vertices, one 3-float slot a corner;
//   (a2) each cell gathers its vertex's cotangent from the 8 voxels that
//        read it and divides by its weight;
//   (a3) each voxel gathers, from the 8 vertices it has a corner at, the
//        cotangents of its position and quaternion and of the strains its
//        corners read: its own bonds' near sides, and the far sides of the
//        bonds below it, which it leaves for their owners;
//   (b)  each bond adds its two sides' strain cotangents to its strain's.
// Gather form throughout, no atomics. Nothing flows into a selection's
// predicate (a face's exposure, v.n > 0).
//
// The material instance (MAT; on land fused_rollout_bwd_mat_kernel and its
// device-memory twin in fused_rollout_bwd_mat.cu, in water and with growth
// fused_rollout_bwd_matvar_kernel in fused_rollout_bwd_matvar.cu,
// translation units of their own) differentiates Voxelyze's bilinear stress and
// the max-velocity clamp, as _make_kernel(bwd=True)'s jax.vjp does through
// _bond_dir's nonlinear branch (:513-541, with _vox_mat_stress_k :370-404)
// and the displacement clamp (:1519-1530). The recompute is K1's material
// instance itself (k1_steps with MAT), so every predicate is decided on
// the bits K1's material launch saw. The bond pass takes the stress's slope
// at the bond's strain from bond_forward<..., SLOPE> (a tangent carried
// forward beside the 3-iteration stress equalization, in place of the
// linear stiffness); the integration phase takes the clamp's adjoint: where
// |dp| > max_disp, dp = lin' dt / m was scaled by back = max_disp / |dp|,
// and the cotangent of dp is back (I - u u^T) g_pos with u = dp / |dp|.
// lin' is already the next tape slot's, so the tape keeps its 48 channels.
// With the facet drag the corners read the stress equalization's per-side
// strains, which the recompute tapes as the linear instance's; the bond
// pass pulls their cotangents back through the equalization's 3 iterations
// with the tangents bond_forward<..., SLOPE, V_FLUID_MESH> carries beside
// them. The fluid actuation and the development ramps' "keep last" branch
// compose with the clamp's adjoint unchanged: the clamp acts on the
// position, the actuation on the scale.
// MDL_DATA, plasticity, equilibrium mode and BC regions stay outside the
// envelope, as the JAX package's _diff_envelope_ok has it.
#pragma once
#include "k1_step.cuh"
#ifndef EVOSORO_HOST_EMULATION
#include <cooperative_groups.h>
#endif
namespace cg = cooperative_groups;

#define NT 48  // tape channels a slot: S_DIFF carried channels + the static flags
#define NT_MESH (NT + 6)  // ... + the step's per-side bond strains (facet drag)
#define B4_MESH_SCR 27    // scratch floats a voxel (facet drag): 3 + 24
#define NB 8   // cotangent floats a bond sends to its other end: pos 3, quat 4, scale 1

__device__ __forceinline__ void add3(F3& a, F3 b) { a.x += b.x; a.y += b.y; a.z += b.z; }
__device__ __forceinline__ void addq(Q& a, Q b) { a.w += b.w; a.x += b.x; a.y += b.y; a.z += b.z; }

// vjp of qmul(a, b): g is the cotangent of the product
__device__ __forceinline__ void qmul_vjp(Q a, Q b, Q g, Q& ca, Q& cb) {
    ca.w += g.w * b.w + g.x * b.x + g.y * b.y + g.z * b.z;
    ca.x += -g.w * b.x + g.x * b.w - g.y * b.z + g.z * b.y;
    ca.y += -g.w * b.y + g.x * b.z + g.y * b.w - g.z * b.x;
    ca.z += -g.w * b.z - g.x * b.y + g.y * b.x + g.z * b.w;
    cb.w += g.w * a.w + g.x * a.x + g.y * a.y + g.z * a.z;
    cb.x += -g.w * a.x + g.x * a.w + g.y * a.z - g.z * a.y;
    cb.y += -g.w * a.y - g.x * a.z + g.y * a.w + g.z * a.x;
    cb.z += -g.w * a.z + g.x * a.y - g.y * a.x + g.z * a.w;
}

// vjp of qrot_inv(q, v), through its two bilinear stages
__device__ __forceinline__ void qrot_inv_vjp(Q q, F3 v, F3 g, Q& cq, F3& cv) {
    const float tw = q.x * v.x + q.y * v.y + q.z * v.z;
    const float tx = q.w * v.x - q.y * v.z + q.z * v.y;
    const float ty = q.w * v.y + q.x * v.z - q.z * v.x;
    const float tz = q.w * v.z - q.x * v.y + q.y * v.x;
    const float ctw = g.x * q.x + g.y * q.y + g.z * q.z;
    const float ctx = g.x * q.w - g.y * q.z + g.z * q.y;
    const float cty = g.x * q.z + g.y * q.w - g.z * q.x;
    const float ctz = -g.x * q.y + g.y * q.x + g.z * q.w;
    cq.w += g.x * tx + g.y * ty + g.z * tz + ctx * v.x + cty * v.y + ctz * v.z;
    cq.x += g.x * tw + g.y * tz - g.z * ty + ctw * v.x + cty * v.z - ctz * v.y;
    cq.y += -g.x * tz + g.y * tw + g.z * tx + ctw * v.y - ctx * v.z + ctz * v.x;
    cq.z += g.x * ty - g.y * tx + g.z * tw + ctw * v.z + ctx * v.y - cty * v.x;
    cv.x += ctw * q.x + ctx * q.w - cty * q.z + ctz * q.y;
    cv.y += ctw * q.y + ctx * q.z + cty * q.w - ctz * q.x;
    cv.z += ctw * q.z - ctx * q.y + cty * q.x + ctz * q.w;
}

// vjp of q_to_rotvec: rv = xyz * scale(w); at sq_len <= 0 scale is the
// constant 2
__device__ inline Q rotvec_vjp(Q q, F3 g, const Params& p) {
    const float sq_len = 1.f - q.w * q.w;
    const bool pos = sq_len > 0.f;
    if (!pos) return {0.f, 2.f * g.x, 2.f * g.y, 2.f * g.z};
    const float wc = fminf(q.w, 1.f);
    const float inv_sqrt = 1.f / sqrtf(sq_len);
    const float d_inv = q.w * inv_sqrt / sq_len;  // d inv_sqrt / dw
    float scale, d_scale;
    if (sq_len < p.sl_thresh) {
        const float fa = fmaxf(2.f - 2.f * wc, 0.f);
        const float rt = sqrtf(fa);
        scale = 2.f * rt * inv_sqrt;
        // fa > 0 here: sq_len > 0 means |w| < 1
        d_scale = 2.f * (-1.f / rt) * inv_sqrt + 2.f * rt * d_inv;
    } else {
        const float sa = fminf(fmaxf(wc, -1.f), 1.f);
        const float ac = acosf(sa);
        scale = 2.f * ac * inv_sqrt;
        d_scale = 2.f * (-1.f / sqrtf(1.f - sa * sa)) * inv_sqrt + 2.f * ac * d_inv;
    }
    const float c_scale = g.x * q.x + g.y * q.y + g.z * q.z;
    return {c_scale * d_scale, g.x * scale, g.y * scale, g.z * scale};
}

// vjp of q_from_angle_to_pos_x; the x component of its result is constant
__device__ inline F3 angle_to_pos_x_vjp(F3 v, Q g, const Params& p) {
    const float safe_vx = v.x != 0.f ? v.x : 1.f;
    const float yox = v.y / safe_vx;
    const float zox = v.z / safe_vx;
    const bool small = fabsf(yox) < p.sa_rad && fabsf(zox) < p.sa_rad && v.x != 0.f;
    const float norm2 = v.x * v.x + v.y * v.y + v.z * v.z;
    if (norm2 == 0.f) return {0.f, 0.f, 0.f};
    if (small) {
        const float qs_y = 0.5f * zox;
        const float qs_z = -0.5f * yox;
        const float c_qs_y = g.y - g.w * qs_y;
        const float c_qs_z = g.z - g.w * qs_z;
        const float c_zox = 0.5f * c_qs_y;
        const float c_yox = -0.5f * c_qs_z;
        return {-(c_yox * yox + c_zox * zox) / safe_vx, c_yox / safe_vx, c_zox / safe_vx};
    }
    const float inv_norm = 1.f / sqrtf(norm2);
    const float nx = v.x * inv_norm, ny = v.y * inv_norm, nz = v.z * inv_norm;
    const float nxg = fminf(fmaxf(nx, -1.f), 1.f);
    const float theta = acosf(nxg);
    if (theta > p.anti) return {0.f, 0.f, 0.f};
    const float yz2 = nz * nz + ny * ny;
    const float ami = 1.f / sqrtf(yz2 > 0.f ? yz2 : 1.f);
    const float half = 0.5f * theta;
    const float s = sinf(half), c = cosf(half);
    const float c_half = -g.w * s + (g.y * (nz * ami) - g.z * (ny * ami)) * c;
    float c_nz = g.y * ami * s;
    float c_ny = -g.z * ami * s;
    const float c_ami = (g.y * nz - g.z * ny) * s;
    if (yz2 > 0.f) {
        const float c_yz2 = c_ami * (-0.5f * ami / yz2);
        c_nz += 2.f * nz * c_yz2;
        c_ny += 2.f * ny * c_yz2;
    }
    float c_nx = 0.f;
    if (nx >= -1.f && nx <= 1.f) c_nx = 0.5f * c_half * (-1.f / sqrtf(1.f - nxg * nxg));
    const float c_inv = c_nx * v.x + c_ny * v.y + c_nz * v.z;
    const float c_norm2 = c_inv * (-0.5f * inv_norm / norm2);
    return {c_nx * inv_norm + 2.f * v.x * c_norm2, c_ny * inv_norm + 2.f * v.y * c_norm2,
            c_nz * inv_norm + 2.f * v.z * c_norm2};
}

// vjp of qrot(q, f), through its two bilinear stages
__device__ __forceinline__ void qrot_vjp(Q q, F3 f, F3 g, Q& cq, F3& cf) {
    const float tw = f.x * q.x + f.y * q.y + f.z * q.z;
    const float tx = f.x * q.w - f.y * q.z + f.z * q.y;
    const float ty = f.x * q.z + f.y * q.w - f.z * q.x;
    const float tz = -f.x * q.y + f.y * q.x + f.z * q.w;
    const float ctw = g.x * q.x + g.y * q.y + g.z * q.z;
    const float ctx = g.x * q.w + g.y * q.z - g.z * q.y;
    const float cty = -g.x * q.z + g.y * q.w + g.z * q.x;
    const float ctz = g.x * q.y - g.y * q.x + g.z * q.w;
    cq.w += g.x * tx + g.y * ty + g.z * tz + ctx * f.x + cty * f.y + ctz * f.z;
    cq.x += g.x * tw - g.y * tz + g.z * ty + ctw * f.x - cty * f.z + ctz * f.y;
    cq.y += g.x * tz + g.y * tw - g.z * tx + ctw * f.y + ctx * f.z - ctz * f.x;
    cq.z += -g.x * ty + g.y * tx + g.z * tw + ctw * f.z - ctx * f.y + cty * f.x;
    cf.x += ctw * q.x + ctx * q.w + cty * q.z - ctz * q.y;
    cf.y += ctw * q.y - ctx * q.z + cty * q.w + ctz * q.x;
    cf.z += ctw * q.z + ctx * q.y - cty * q.x + ctz * q.w;
}

// vjp of facet_drag (fused_rollout_common.cuh) on voxel v: g, the cotangent
// of the drag force. Adds the velocity's cotangent to *c_vel and writes the
// cotangents of the 8 vertices it read to ck[k][3][V] (k = 4 cx + 2 cy + cz,
// the vertex at cell v + (cx, cy, cz)). A facet facing away, and the guard
// of the normal's length, pass nothing.
__device__ inline void facet_drag_vjp(const float* vert, const float* occ, int v,
                                      const int coord[3], int X, int Y, int Z, F3 vel,
                                      float dragc, F3 g, F3& c_vel, float* ck) {
    const int V = X * Y * Z;
    const int dims[3] = {X, Y, Z};
    const int strides[3] = {Y * Z, Z, 1};
    F3 vt[8], cv[8];
    for (int k = 0; k < 8; ++k) {
        const int c = v + ((k >> 2) & 1) * strides[0] + ((k >> 1) & 1) * strides[1] + (k & 1);
        vt[k] = {vert[c], vert[V + c], vert[2 * V + c]};
        cv[k] = {0.f, 0.f, 0.f};
    }
    const int quads[6][4] = {{4, 6, 7, 5}, {0, 1, 3, 2}, {2, 3, 7, 6},
                             {0, 4, 5, 1}, {1, 5, 7, 3}, {0, 2, 6, 4}};
    for (int f = 0; f < 6; ++f) {
        const int a = f >> 1;
        const bool plus = !(f & 1);
        const bool has_nbr = plus ? (coord[a] + 1 < dims[a] && occ[v + strides[a]] > 0.5f)
                                  : (coord[a] > 0 && occ[v - strides[a]] > 0.5f);
        if (has_nbr) continue;
        for (int tri = 0; tri < 2; ++tri) {
            const int ia = quads[f][0], ib = quads[f][1 + tri], ic = quads[f][2 + tri];
            const F3 pa = vt[ia], pb = vt[ib], pc = vt[ic];
            const F3 e1 = {pb.x - pa.x, pb.y - pa.y, pb.z - pa.z};
            const F3 e2 = {pc.x - pa.x, pc.y - pa.y, pc.z - pa.z};
            const F3 n = {e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z,
                          e1.x * e2.y - e1.y * e2.x};
            const float s = n.x * n.x + n.y * n.y + n.z * n.z;
            const float n_len = sqrtf(fmaxf(s, 1e-30f));
            const float area = 0.5f * n_len;
            const F3 h = {n.x / n_len, n.y / n_len, n.z / n_len};
            const float vn = vel.x * h.x + vel.y * h.y + vel.z * h.z;
            if (!(vn > 0.f)) continue;
            // force = -mag h, mag = C area vn^2
            const float mag = dragc * area * vn * vn;
            const float c_mag = -(g.x * h.x + g.y * h.y + g.z * h.z);
            F3 c_h = {-mag * g.x, -mag * g.y, -mag * g.z};
            const float c_area = c_mag * dragc * vn * vn;
            const float c_vn = c_mag * dragc * area * 2.f * vn;
            c_vel.x += c_vn * h.x; c_vel.y += c_vn * h.y; c_vel.z += c_vn * h.z;
            c_h.x += c_vn * vel.x; c_h.y += c_vn * vel.y; c_h.z += c_vn * vel.z;
            // h = n / |n|, area = |n| / 2
            const float c_len = 0.5f * c_area
                                - (c_h.x * n.x + c_h.y * n.y + c_h.z * n.z) / (n_len * n_len);
            F3 c_n = {c_h.x / n_len, c_h.y / n_len, c_h.z / n_len};
            if (s > 1e-30f) {
                const float c_s2 = 2.f * (c_len * 0.5f / n_len);
                c_n.x += n.x * c_s2; c_n.y += n.y * c_s2; c_n.z += n.z * c_s2;
            }
            // n = e1 x e2
            const F3 c_e1 = {e2.y * c_n.z - e2.z * c_n.y, e2.z * c_n.x - e2.x * c_n.z,
                             e2.x * c_n.y - e2.y * c_n.x};
            const F3 c_e2 = {c_n.y * e1.z - c_n.z * e1.y, c_n.z * e1.x - c_n.x * e1.z,
                             c_n.x * e1.y - c_n.y * e1.x};
            add3(cv[ib], c_e1);
            add3(cv[ic], c_e2);
            cv[ia].x -= c_e1.x + c_e2.x; cv[ia].y -= c_e1.y + c_e2.y;
            cv[ia].z -= c_e1.z + c_e2.z;
        }
    }
    for (int k = 0; k < 8; ++k) {
        ck[(size_t)(3 * k) * V + v] = cv[k].x;
        ck[(size_t)(3 * k + 1) * V + v] = cv[k].y;
        ck[(size_t)(3 * k + 2) * V + v] = cv[k].z;
    }
}

// vjp of the max-velocity clamp (core/step.py _max_vel_clamp): the
// displacement dp is scaled by back = max_disp / |dp| where |dp| > max_disp;
// g, the clamped displacement's cotangent, comes back as dp's,
// back (I - u u^T) g with u = dp / |dp|, and unchanged where it was not
// clamped (where the plain version's guards, |dp| > 0 among them, cut)
__device__ __forceinline__ F3 max_vel_clamp_vjp(F3 dp, float max_disp, F3 g) {
    const float sq = dp.x * dp.x + dp.y * dp.y + dp.z * dp.z;
    const float dmag = sq > 0.f ? sqrtf(sq) : 0.f;
    if (!(dmag > max_disp)) return g;
    const float back = max_disp / dmag;
    const F3 u = {dp.x / dmag, dp.y / dmag, dp.z / dmag};
    const float ug = u.x * g.x + u.y * g.y + u.z * g.z;
    return {back * (g.x - u.x * ug), back * (g.y - u.y * ug), back * (g.z - u.z * ug)};
}

// Cotangents one bond sends back: to its own voxel (p1, qa, s1), to the
// other end (p2, qb, s2), and to the memory it read
struct BondCot {
    F3 p1, p2;
    Q qa, qb;
    float s1, s2, maxs;
    F3 lp2, la1, la2;
};

// The adjoint of the bond pass for bond (v, d). bn: its forward pass on the
// step's start state. gF1, gM1 (gF2, gM2): cotangents of the world-frame
// force and moment it gives its own voxel (the other end); g_lp2, g_la1,
// g_la2, g_maxs: cotangents of the memory it writes. g_strain (facet drag
// only): the cotangent of its strain through the mesh's corners.
template <int VARIANT = V_LAND>
__device__ inline BondCot bond_vjp(const Bond& bn, const float* bd, int d, int V,
                                   const Params& p, float dt_inv, float maxs_old,
                                   F3 gF1, F3 gM1, F3 gF2, F3 gM2, F3 g_lp2, F3 g_la1,
                                   F3 g_la2, float g_maxs, float g_strain = 0.f) {
    const Q q0 = {0.f, 0.f, 0.f, 0.f};
    const F3 z3 = {0.f, 0.f, 0.f};
    // world frame -> bond frame: four vectors rotated by the same totrot
    Q c_tot = q0;
    F3 cf1 = z3, cf2 = z3, cm1 = z3, cm2 = z3;
    qrot_inv_vjp(bn.totrot, bn.f1, to_x(d, gF1), c_tot, cf1);
    qrot_inv_vjp(bn.totrot, bn.f2, to_x(d, gF2), c_tot, cf2);
    qrot_inv_vjp(bn.totrot, bn.m1, to_x(d, gM1), c_tot, cm1);
    qrot_inv_vjp(bn.totrot, bn.m2, to_x(d, gM2), c_tot, cm2);

    F3 c_pos2 = z3, c_ra1 = z3, c_ra2 = z3;
    BondCot o;
    o.lp2 = z3; o.la1 = z3; o.la2 = z3;
    if (bn.damped) {  // the damping terms, linear in the three rates
        const float da1m1 = bd[(size_t)D_DA1M1 * V], da1m2 = bd[(size_t)D_DA1M2 * V];
        const float da2i1 = bd[(size_t)D_DA2I1 * V], da2i2 = bd[(size_t)D_DA2I2 * V];
        const float db1m1 = bd[(size_t)D_DB1M1 * V], db1m2 = bd[(size_t)D_DB1M2 * V];
        const float db2fm1 = bd[(size_t)D_DB2FM1 * V], db2fm2 = bd[(size_t)D_DB2FM2 * V];
        const float db3i1 = bd[(size_t)D_DB3I1 * V], db3i2 = bd[(size_t)D_DB3I2 * V];
        const float bz = p.bondz, hz = p.hbondz;
        const F3 c_rv = {
            bz * (da1m1 * cf1.x - da1m2 * cf2.x),
            bz * (db1m1 * cf1.y - db1m2 * cf2.y) + hz * (-db2fm1 * cm1.z - db2fm2 * cm2.z),
            bz * (db1m1 * cf1.z - db1m2 * cf2.z) + hz * (db2fm1 * cm1.y + db2fm2 * cm2.y)};
        const float c_sum_avz = bz * (-db2fm1 * cf1.y + db2fm2 * cf2.y);
        const float c_sum_avy = bz * (db2fm1 * cf1.z - db2fm2 * cf2.z);
        const float c_davx = hz * (-da2i1 * cm1.x + da2i2 * cm2.x);
        const F3 c_rav1 = {-c_davx,
                           c_sum_avy + hz * (2.f * db3i1 * cm1.y + db3i2 * cm2.y),
                           c_sum_avz + hz * (2.f * db3i1 * cm1.z + db3i2 * cm2.z)};
        const F3 c_rav2 = {c_davx,
                           c_sum_avy + hz * (db3i1 * cm1.y + 2.f * db3i2 * cm2.y),
                           c_sum_avz + hz * (db3i1 * cm1.z + 2.f * db3i2 * cm2.z)};
        // rate = (new - old memory) * dt_inv
        c_pos2 = {c_rv.x * dt_inv, c_rv.y * dt_inv, c_rv.z * dt_inv};
        c_ra1 = {c_rav1.x * dt_inv, c_rav1.y * dt_inv, c_rav1.z * dt_inv};
        c_ra2 = {c_rav2.x * dt_inv, c_rav2.y * dt_inv, c_rav2.z * dt_inv};
        o.lp2 = {-c_pos2.x, -c_pos2.y, -c_pos2.z};
        o.la1 = {-c_ra1.x, -c_ra1.y, -c_ra1.z};
        o.la2 = {-c_ra2.x, -c_ra2.y, -c_ra2.z};
    }

    // the beam's undamped forces and moments; f2 = -f1 there
    const float a2c = bd[(size_t)D_A2 * V], b1 = bd[(size_t)D_B1 * V];
    const float b2 = bd[(size_t)D_B2 * V], b3 = bd[(size_t)D_B3 * V];
    const F3 cfb = {cf1.x - cf2.x, cf1.y - cf2.y, cf1.z - cf2.z};
    c_pos2.y += b1 * cfb.y - b2 * (cm1.z + cm2.z);
    c_pos2.z += b1 * cfb.z + b2 * (cm1.y + cm2.y);
    c_ra1.x += a2c * (cm1.x - cm2.x);
    c_ra2.x += a2c * (cm2.x - cm1.x);
    c_ra1.y += b2 * cfb.z + b3 * (2.f * cm1.y + cm2.y);
    c_ra2.y += b2 * cfb.z + b3 * (cm1.y + 2.f * cm2.y);
    c_ra1.z += -b2 * cfb.y + b3 * (2.f * cm1.z + cm2.z);
    c_ra2.z += -b2 * cfb.y + b3 * (cm1.z + 2.f * cm2.z);

    // the memory: refreshed from this step's values unless the bond changed
    // frame, in which case the old memory was carried over
    if (!bn.changed) {
        add3(c_pos2, g_lp2);
        add3(c_ra1, g_la1);
        add3(c_ra2, g_la2);
    } else {
        add3(o.lp2, g_lp2);
        add3(o.la1, g_la1);
        add3(o.la2, g_la2);
    }

    // strain: stress = stiff * strain, max-strain memory (ties in halves)
    float c_strain = bn.stiff * (p.cs_area * cfb.x);
    if constexpr (VARIANT == V_FLUID_MESH) c_strain += g_strain;
    o.maxs = 0.f;
    if (bn.strain > maxs_old) c_strain += g_maxs;
    else if (bn.strain == maxs_old) { c_strain += 0.5f * g_maxs; o.maxs = 0.5f * g_maxs; }
    else o.maxs = g_maxs;
    c_pos2.x += c_strain / p.L;

    // the two frames
    Q c_q1 = q0, c_q2 = q0;
    F3 c_ar = z3, c_rel = z3;
    float c_nom = -c_pos2.x;
    if (bn.small) {
        c_ar = c_pos2;                                 // pos2 = ar - (nom, 0, 0)
        const Q c_na2 = rotvec_vjp(bn.na2, c_ra2, p);  // ra2 = rotvec(na2)
        Q c_cq1 = c_tot;                               // totrot = conj(q1)
        qmul_vjp(qconj(bn.q1), bn.q2, c_na2, c_cq1, c_q2);
        addq(c_q1, qconj(c_cq1));
    } else {
        Q c_p2ar = rotvec_vjp(bn.p2ar, c_ra1, p);      // ra1 = rotvec(p2ar)
        const Q c_tq2 = rotvec_vjp(bn.tq2, c_ra2, p);  // ra2 = rotvec(totrot * q2)
        qmul_vjp(bn.totrot, bn.q2, c_tq2, c_tot, c_q2);
        Q c_cq1 = q0;                                  // totrot = p2ar * conj(q1)
        qmul_vjp(bn.p2ar, qconj(bn.q1), c_tot, c_p2ar, c_cq1);
        addq(c_q1, qconj(c_cq1));
        c_ar = angle_to_pos_x_vjp(bn.ar, c_p2ar, p);
        if (bn.length > 0.f) {                         // pos2.x = |rel| - nom
            const float k = c_pos2.x / bn.length;
            c_rel = {k * bn.rel.x, k * bn.rel.y, k * bn.rel.z};
        }
    }
    qrot_inv_vjp(bn.q1, bn.rel, c_ar, c_q1, c_rel);    // ar = qrot_inv(q1, rel)

    // lattice rotation back, and the two ends
    const F3 g_rel = to_orig(d, c_rel);
    o.p1 = {-g_rel.x, -g_rel.y, -g_rel.z};
    o.p2 = g_rel;
    const F3 qa3 = to_orig(d, {c_q1.x, c_q1.y, c_q1.z});
    const F3 qb3 = to_orig(d, {c_q2.x, c_q2.y, c_q2.z});
    o.qa = {c_q1.w, qa3.x, qa3.y, qa3.z};
    o.qb = {c_q2.w, qb3.x, qb3.y, qb3.z};
    o.s1 = 0.5f * c_nom;
    o.s2 = 0.5f * c_nom;
    return o;
}

// Tape channels a slot of variant VARIANT
template <int VARIANT>
__host__ __device__ constexpr int tape_channels() {
    return VARIANT == V_FLUID_MESH ? NT_MESH : NT;
}

// B4's block: its kernels' __launch_bounds__(B4_BOUND, 1), the fastest of
// 256, 384 and 512 threads in every instance on the card but growth (1-2 %
// behind 384), 128 registers with 8-152 bytes of spills (PERF.md §6).
// A launch takes min(B4_BOUND, 3 V rounded up to a warp): the recompute's
// bond items, never fewer than the reductions' partition (k1_red_threads).
#define B4_BOUND 512
static_assert(B4_BOUND >= K1_RED_THREADS && B4_BOUND <= 768, "k1_steps' reductions");
__host__ __device__ inline int b4_threads(int V) {
    return B4_BOUND < (3 * V + 31) / 32 * 32 ? B4_BOUND : (3 * V + 31) / 32 * 32;
}

// The reverse sweep's floats a voxel, in a slab a block: the force and
// moment cotangents (ctf, ctm: 3 + 3), what each bond (v, d) sends to
// v + stride_d (nbc: 3 NB) and to v itself (own: 3 NB)
#define B4_SLAB (6 + 6 * NB)
// the kernels' static shared memory is below this (k1_steps' reductions and
// flags, the step count); ops/fused_rollout.py _K1_STATIC_SMEM
#define B4_STATIC_SMEM 208
#define B4_MAX_CLUSTER 8  // blocks a robot: the portable cluster size

// x-planes a block of a robot's cluster owns (the last block may own
// fewer), so C = ceil(X / planes) blocks a robot. One block (all X planes)
// when a block takes a step's 3 V bond items in one go; else the most
// blocks, up to B4_MAX_CLUSTER, for which the card holds all B clusters at
// once (at_once(C, planes): cudaOccupancyMaxActiveClusters of that shape),
// so that the launch is one wave; one block where no cluster shape is.
// `cluster` > 0 asks for that many blocks (ceil(X / ceil(X / cluster))).
template <class F>
inline int b4_planes(int B, int X, int Y, int Z, int threads, int cluster, F at_once) {
    if (cluster > 0) {
        const int c = cluster > X ? X : cluster;
        return (X + c - 1) / c;
    }
    if (3 * X * Y * Z <= threads) return X;
    for (int c = B4_MAX_CLUSTER < X ? B4_MAX_CLUSTER : X; c >= 2; --c) {
        const int planes = (X + c - 1) / c;
        if (at_once((X + planes - 1) / planes, planes) >= B) return planes;
    }
    return X;
}

// The forward recompute of a segment into the tape, by the whole block:
// the state it starts from into slot 0, then K1's own step loop in its
// tape form (k1_steps<..., TAPE>), so every predicate below is decided on
// the very values the forward launch saw; the material instance (MAT) with
// the robot's inputs ma, the facet drag with its per-side strains in the
// slots' own channels past NT. buf: K1's buffer (k1_buffer_floats without
// contact). Thread 0 leaves the count of steps taken in *taken.
template <int VARIANT, bool MAT = false>
__device__ inline void b4_recompute(const float* st0, const float* bo, const float* cu_robot,
                                    int n_knots, int knot_steps, int step_base, int X, int Y,
                                    int Z, int num_steps, const Params& p, int flags, Robot& r,
                                    float* tape, float* tape_t, float* buf, int* taken,
                                    const MatArgs* ma = nullptr) {
    const int V = X * Y * Z;
    const size_t slot = (size_t)tape_channels<VARIANT>() * V;
    for (int k = threadIdx.x; k < S_DIFF * V; k += blockDim.x) tape[k] = st0[k];
    __syncthreads();
    if constexpr (MAT) {
        // equilibrium mode is outside the envelope: the ring is never read
        float ke[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        k1_steps<VARIANT, false, true, false, false, false, true>(
            tape, bo, nullptr, cu_robot, n_knots, knot_steps, step_base, X, Y, Z, num_steps, p,
            flags, r, buf, VARIANT == V_FLUID_MESH ? tape + (size_t)NT * V : nullptr, nullptr,
            nullptr, ma, ke, nullptr, K1Tape{slot, tape_t, taken});
    } else {
        k1_steps<VARIANT, false, false, false, false, false, true>(
            tape, bo, nullptr, cu_robot, n_knots, knot_steps, step_base, X, Y, Z, num_steps, p,
            flags, r, buf, VARIANT == V_FLUID_MESH ? tape + (size_t)NT * V : nullptr, nullptr,
            nullptr, nullptr, nullptr, nullptr, K1Tape{slot, tape_t, taken});
    }
}

// One robot's cluster: C blocks, each owning `planes` x-planes (block k
// planes [k planes, (k + 1) planes) clipped to X) and the bonds whose lower
// end lies in them. slab: with stride 0, this block's slab in shared memory
// (the others' through map_shared_rank); else rank 0's in device memory,
// rank k's `stride` floats on. On the host, where one thread stands for the
// whole cluster, the slabs lie in one array (stride > 0) and every rank's
// share of a pass runs in turn (each_rank).
struct B4Part {
    int C, planes, rank;
    float* slab;
    size_t stride;
};

__device__ inline float* b4_slab(const B4Part& pt, int k) {
    if (pt.stride) return pt.slab + (size_t)k * pt.stride;
    if (k == pt.rank) return pt.slab;
    return cg::this_cluster().map_shared_rank(pt.slab, k);
}

// f(k) for the ranks this thread works for: its own block's on the card,
// all of them in turn on the host
template <class F>
__device__ inline void each_rank(const B4Part& pt, F f) {
#ifdef EVOSORO_HOST_EMULATION
    for (int k = 0; k < pt.C; ++k) f(k);
#else
    f(pt.rank);
#endif
}

// the barrier between two passes: the cluster's (it orders shared and
// device memory across its blocks), or the block's alone
__device__ inline void b4_sync(const B4Part& pt) {
    if (pt.C > 1) cg::this_cluster().sync();
    else __syncthreads();
}

// The whole launch for one robot, run by the blocks of its cluster (pt).
// tape: (num_steps + 1, tape_channels, V) floats; tape_t: num_steps floats;
// cot: (C_S, V), the END state's cotangent on entry and the START state's
// on return; cot_u: (K, V), zero on entry; buf: the recompute's K1 buffer
// (rank 0 only; the slabs may lie in it, which the recompute no longer
// needs once it has finished); scr: (B4_MESH_SCR, V) floats of scratch
// (V_FLUID_MESH only). MAT: the material instance, with the robot's inputs
// ma.
template <int VARIANT, bool MAT = false>
__device__ inline void reverse_segment(const float* st0, const float* bo, const float* stat,
                                       const float* cu_robot, int n_knots, int knot_steps,
                                       int step_base, int X, int Y, int Z, int num_steps,
                                       const Params& p, int flags, float* tape,
                                       float* tape_t, float* cot, float* cot_u, float* buf,
                                       const B4Part& pt, float* scr = nullptr,
                                       const MatArgs* ma = nullptr) {
    constexpr bool MESH = VARIANT == V_FLUID_MESH;
    __shared__ int n_sh;  // rank 0's count of steps taken
    const int V = X * Y * Z;
    const int YZ = Y * Z;
    const int T = blockDim.x;
    const int strides[3] = {YZ, Z, 1};
    const size_t slot = (size_t)tape_channels<VARIANT>() * V;
    const int Vs = pt.planes * YZ;  // a slab's voxels

    // ---- forward recompute into the tape, on rank 0; the others wait ----
    Robot r = load_robot(stat);
    const float dt = r.dt, dt_inv = r.dt_inv;
    if (pt.rank == 0) {
        // small_angle and the channels outside the rollout carry no gradient
        for (int k = threadIdx.x; k < (C_S - S_DIFF) * V; k += T)
            cot[(size_t)S_DIFF * V + k] = 0.f;
        for (int k = threadIdx.x; k < 3 * V; k += T) cot[(size_t)S_SMALL * V + k] = 0.f;
        b4_recompute<VARIANT, MAT>(st0, bo, cu_robot, n_knots, knot_steps, step_base, X, Y, Z,
                                   num_steps, p, flags, r, tape, tape_t, buf, &n_sh, ma);
    }
    b4_sync(pt);
    const int n_done = pt.C > 1 ? *cg::this_cluster().map_shared_rank(&n_sh, 0) : n_sh;

    // (facet drag) device scratch: the vertex field, then each vertex's
    // cotangent over its weight; the corners' cotangents [8][3][V], then the
    // strains' [6][V] (a voxel's own bonds' near sides, the bonds below it's
    // far sides)
    float* vfield = scr;
    float* ck = MESH ? scr + (size_t)3 * V : nullptr;
    const float half_l = 0.5f * p.L;
    // rank rk's voxels [first(rk), last(rk))
    const auto first = [&](int rk) { return rk * pt.planes * YZ; };
    const auto last = [&](int rk) { return min((rk + 1) * pt.planes, X) * YZ; };

#define SCH(k) (si + (size_t)(k) * V)
#define BCH(k) (bo + (size_t)(k) * V)
#define COT(k) (cot + (size_t)(k) * V)

    // ---- reverse sweep ----
    for (int i = n_done - 1; i >= 0; --i) {
        const float* si = tape + (size_t)i * slot;        // the state step i started from
        const float* sn = tape + (size_t)(i + 1) * slot;  // the state it produced
        const float t = tape_t[i];
        float* cu_out = cot_u + (size_t)knot_of(step_base + i, n_knots, knot_steps) * V;

        if constexpr (MESH) {
            // (a0) the step's mesh, as K1's phase B1 built it
            each_rank(pt, [&](int rk) {
                for (int v = first(rk) + threadIdx.x; v < last(rk); v += T) {
                    const int coord[3] = {v / YZ, (v / Z) % Y, v % Z};
                    const F3 vx = mesh_vertex(si, BCH(B_OCC), si + (size_t)NT * V, coord[0],
                                              coord[1], coord[2], Y, Z, V, half_l);
                    vfield[v] = vx.x; vfield[V + v] = vx.y; vfield[2 * V + v] = vx.z;
                }
            });
            b4_sync(pt);
        }

        // (a) integration phase, a voxel a thread
        each_rank(pt, [&](int rk) {
            float* ctf = b4_slab(pt, rk);  // [3][Vs] cotangent of each voxel's force sum
            float* ctm = ctf + 3 * Vs;    // [3][Vs] ... and of its moment sum
            const int v0 = first(rk);
            for (int v = v0 + threadIdx.x; v < last(rk); v += T) {
                const int lv = v - v0;
                const bool occ = BCH(B_OCC)[v] > 0.5f;
                const float mass = BCH(B_MASS)[v];
                const float minv = BCH(B_MASS_INV)[v];
                const float tsm = BCH(B_2SQ_MEXS)[v];
                const float iinv = BCH(B_INERTIA_INV)[v];
                const float ang_fact = 1.f - p.ten_slow * iinv * BCH(B_2SQ_IEXSSS)[v] * dt;
                const float scale = SCH(S_SCALE)[v];
                const F3 z3 = {0.f, 0.f, 0.f};
                // empty cells are reset to constants: their cotangents stop here
                const F3 g_pos = occ ? F3{COT(S_POS)[v], COT(S_POS + 1)[v], COT(S_POS + 2)[v]} : z3;
                F3 g_lin = occ ? F3{COT(S_LIN)[v], COT(S_LIN + 1)[v], COT(S_LIN + 2)[v]} : z3;
                F3 c_angp = occ ? F3{COT(S_ANG)[v], COT(S_ANG + 1)[v], COT(S_ANG + 2)[v]} : z3;
                const Q g_q = {COT(S_QUAT)[v], COT(S_QUAT + 1)[v], COT(S_QUAT + 2)[v],
                               COT(S_QUAT + 3)[v]};
                const float g_scale = COT(S_SCALE)[v];

                // actuation: the clamps' "keep last" branch is the old scale; the
                // knot adds u * L for occupied voxels. The land_water actuation
                // of a fluid does not read the old scale.
                float c_scale = 0.f;
                if constexpr (VARIANT == V_LAND) {
                    bool kept_last;
                    actuation_scale(t, scale, BCH(B_AMPDAMP)[v], BCH(B_PHASE)[v], BCH(B_CTE)[v],
                                    r.tamp, r.tper, r.init_cm, r.min_tf, r.gamp, p, flags,
                                    &kept_last);
                    if (occ && kept_last) c_scale = g_scale;
                } else if constexpr (VARIANT == V_DEVO) {
                    const float dv[6] = {BCH(B_INIT_SIZE)[v], BCH(B_FINAL_SIZE)[v],
                                         BCH(B_GROWTH_T)[v], BCH(B_START_GT)[v],
                                         BCH(B_FINAL_PHASE)[v], BCH(B_FINAL_AD)[v]};
                    bool kept_last;
                    development_scale(t, scale, BCH(B_AMPDAMP)[v], BCH(B_PHASE)[v], BCH(B_CTE)[v],
                                      dv, r.tamp, r.tper, r.init_cm, r.min_tf, r.gamp, p, flags,
                                      &kept_last);
                    if (occ && kept_last) c_scale = g_scale;
                }
                if (occ) cu_out[v] += g_scale * p.L;

                // pos' = pos + lin' * (dt * minv)
                F3 c_pos = g_pos;
                const float dtm = dt * minv;
                if constexpr (MAT) {
                    // (the clamp) pos' = pos + dp * back, dp = lin' * dtm
                    F3 g_dp = g_pos;
                    if ((flags & F_MAXVEL) && occ)
                        g_dp = max_vel_clamp_vjp({sn[(size_t)S_LIN * V + v] * dtm,
                                                  sn[(size_t)(S_LIN + 1) * V + v] * dtm,
                                                  sn[(size_t)(S_LIN + 2) * V + v] * dtm},
                                                 ma->max_disp, g_pos);
                    g_lin.x += g_dp.x * dtm; g_lin.y += g_dp.y * dtm; g_lin.z += g_dp.z * dtm;
                } else {
                    g_lin.x += g_pos.x * dtm; g_lin.y += g_pos.y * dtm; g_lin.z += g_pos.z * dtm;
                }

                // quaternion update: qn = normalize(qo + 0.5 * (0, ang' * iinv) * qo * dt),
                // snapped to the identity at w >= 1 (which cuts the cotangent)
                const F3 angp = occ ? F3{sn[(size_t)S_ANG * V + v], sn[(size_t)(S_ANG + 1) * V + v],
                                         sn[(size_t)(S_ANG + 2) * V + v]}
                                    : F3{SCH(S_ANG)[v] * ang_fact, SCH(S_ANG + 1)[v] * ang_fact,
                                         SCH(S_ANG + 2)[v] * ang_fact};
                const Q qo = {SCH(S_QUAT)[v], SCH(S_QUAT + 1)[v], SCH(S_QUAT + 2)[v], SCH(S_QUAT + 3)[v]};
                const Q av4 = {0.f, angp.x * iinv, angp.y * iinv, angp.z * iinv};
                const Q sp4 = qmul(av4, qo);
                const Q qr = {qo.w + 0.5f * sp4.w * dt, qo.x + 0.5f * sp4.x * dt,
                              qo.y + 0.5f * sp4.y * dt, qo.z + 0.5f * sp4.z * dt};
                const float l2 = qr.w * qr.w + qr.x * qr.x + qr.y * qr.y + qr.z * qr.z;
                const float li = l2 > 0.f ? 1.f / sqrtf(l2) : 1.f;
                Q c_qo = {0.f, 0.f, 0.f, 0.f};
                if (!(qr.w * li >= 1.f)) {
                    Q c_qr = {g_q.w * li, g_q.x * li, g_q.y * li, g_q.z * li};
                    if (l2 > 0.f) {
                        const float c_li = g_q.w * qr.w + g_q.x * qr.x + g_q.y * qr.y + g_q.z * qr.z;
                        const float c_l2 = c_li * (-0.5f * li / l2);
                        c_qr.w += 2.f * qr.w * c_l2; c_qr.x += 2.f * qr.x * c_l2;
                        c_qr.y += 2.f * qr.y * c_l2; c_qr.z += 2.f * qr.z * c_l2;
                    }
                    c_qo = c_qr;
                    const float hdt = 0.5f * dt;
                    const Q c_sp4 = {c_qr.w * hdt, c_qr.x * hdt, c_qr.y * hdt, c_qr.z * hdt};
                    Q c_av4 = {0.f, 0.f, 0.f, 0.f};
                    qmul_vjp(av4, qo, c_sp4, c_av4, c_qo);
                    c_angp.x += c_av4.x * iinv; c_angp.y += c_av4.y * iinv; c_angp.z += c_av4.z * iinv;
                }

                // ang' = (ang + tm * dt) * ang_fact
                const F3 c_ang = {c_angp.x * ang_fact, c_angp.y * ang_fact, c_angp.z * ang_fact};
                const F3 c_tm = occ ? F3{c_ang.x * dt, c_ang.y * dt, c_ang.z * dt} : z3;

                // lin' = lin (after the floor's zeroing) + tf * dt
                F3 c_lin = g_lin;
                F3 c_tf = occ ? F3{g_lin.x * dt, g_lin.y * dt, g_lin.z * dt} : z3;
                F3 c_vel = z3;
                if (flags & F_FLOOR) {
                    const F3 vel = {SCH(S_LIN)[v] * minv, SCH(S_LIN + 1)[v] * minv,
                                    SCH(S_LIN + 2)[v] * minv};
                    const float kstiff = BCH(B_LIN_STIFF)[v], ud = BCH(B_UD)[v];
                    const Floor fl = floor_state(scale, SCH(S_POS + 2)[v], vel, kstiff, ud, mass,
                                                 dt, flags);
                    const bool static_flag = SCH(S_DIFF)[v] > 0.5f;
                    const float c_fz = c_tf.z;
                    float c_fx = c_tf.x, c_fy = c_tf.y;
                    if (static_flag) { c_fx = 0.f; c_fy = 0.f; c_tf.x = 0.f; c_tf.y = 0.f; }
                    if (fl.stick || (fl.moving && !fl.keeps_moving)) { c_lin.x = 0.f; c_lin.y = 0.f; }
                    float c_nf = 0.f;
                    if (fl.moving && fl.keeps_moving) {
                        // fx = -vel.x * inv_sv * dyn_fric, inv_sv = 1 / |vel.xy|
                        c_vel.x -= c_fx * fl.dyn_fric * fl.inv_sv;
                        c_vel.y -= c_fy * fl.dyn_fric * fl.inv_sv;
                        const float c_inv_sv = -(c_fx * vel.x + c_fy * vel.y) * fl.dyn_fric;
                        const float c_dyn = -(c_fx * vel.x + c_fy * vel.y) * fl.inv_sv;
                        const float c_sv = -c_inv_sv * fl.inv_sv * fl.inv_sv;
                        const float c_sv2 = c_sv * 0.5f / fl.surface_vel;
                        c_vel.x += 2.f * vel.x * c_sv2;
                        c_vel.y += 2.f * vel.y * c_sv2;
                        c_nf += c_dyn * ud;
                    }
                    if (fl.contact) {
                        // fz = normal_force - col_damp * tsm * vel.z; pen = scale / 2 - pos.z
                        c_nf += c_fz;
                        c_vel.z -= c_fz * (p.col_damp * tsm);
                        const float c_pen = c_nf * kstiff;
                        c_scale += 0.5f * c_pen;
                        c_pos.z -= c_pen;
                    }
                }
                if constexpr (VARIANT == V_FLUID_FACE) {
                    // the voxel-face drag, -+C scale^2 vd^2 on each exposed face
                    // that faces forward along axis d
                    const float velc[3] = {SCH(S_LIN)[v] * minv, SCH(S_LIN + 1)[v] * minv,
                                           SCH(S_LIN + 2)[v] * minv};
                    const float ctfc[3] = {c_tf.x, c_tf.y, c_tf.z};
                    float* cvc[3] = {&c_vel.x, &c_vel.y, &c_vel.z};
                    const int coord[3] = {v / (Y * Z), (v / Z) % Y, v % Z};
                    const float ca = r.dragc * (scale * scale);
                    float c_ca = 0.f;
                    for (int d = 0; d < 3 && occ; ++d) {
                        const float* mk = bo + (size_t)(B_DIR + d * B_PER_DIR + D_MASK) * V;
                        const bool m_pos = mk[v] > 0.5f;
                        const bool m_neg = coord[d] > 0 && mk[v - strides[d]] > 0.5f;
                        const float vd = velc[d];
                        if (!m_pos && vd > 0.f) {
                            *cvc[d] -= ctfc[d] * (2.f * ca * vd);
                            c_ca -= ctfc[d] * (vd * vd);
                        }
                        if (!m_neg && -vd > 0.f) {
                            *cvc[d] += ctfc[d] * (2.f * ca * vd);
                            c_ca += ctfc[d] * (vd * vd);
                        }
                    }
                    c_scale += c_ca * r.dragc * 2.f * scale;
                } else if constexpr (MESH) {
                    // the facet drag: to the velocity here, to the vertices
                    // through the scratch
                    const int coord[3] = {v / (Y * Z), (v / Z) % Y, v % Z};
                    if (occ && coord[0] + 1 < X && coord[1] + 1 < Y && coord[2] + 1 < Z) {
                        const F3 vel = {SCH(S_LIN)[v] * minv, SCH(S_LIN + 1)[v] * minv,
                                        SCH(S_LIN + 2)[v] * minv};
                        facet_drag_vjp(vfield, BCH(B_OCC), v, coord, X, Y, Z, vel, r.dragc, c_tf,
                                       c_vel, ck);
                    } else {
                        for (int k = 0; k < 24; ++k) ck[(size_t)k * V + v] = 0.f;
                    }
                }
                // tf = neg_slow * vel * tsm + (bond forces) [+ gravity], vel = lin * minv
                const float sd = p.neg_slow * tsm;
                c_vel.x += c_tf.x * sd; c_vel.y += c_tf.y * sd; c_vel.z += c_tf.z * sd;
                c_lin.x += c_vel.x * minv; c_lin.y += c_vel.y * minv; c_lin.z += c_vel.z * minv;

                COT(S_POS)[v] = c_pos.x; COT(S_POS + 1)[v] = c_pos.y; COT(S_POS + 2)[v] = c_pos.z;
                COT(S_QUAT)[v] = c_qo.w; COT(S_QUAT + 1)[v] = c_qo.x;
                COT(S_QUAT + 2)[v] = c_qo.y; COT(S_QUAT + 3)[v] = c_qo.z;
                COT(S_LIN)[v] = c_lin.x; COT(S_LIN + 1)[v] = c_lin.y; COT(S_LIN + 2)[v] = c_lin.z;
                COT(S_ANG)[v] = c_ang.x; COT(S_ANG + 1)[v] = c_ang.y; COT(S_ANG + 2)[v] = c_ang.z;
                COT(S_SCALE)[v] = c_scale;
                ctf[lv] = c_tf.x; ctf[Vs + lv] = c_tf.y; ctf[2 * Vs + lv] = c_tf.z;
                ctm[lv] = c_tm.x; ctm[Vs + lv] = c_tm.y; ctm[2 * Vs + lv] = c_tm.z;
            }
        });
        b4_sync(pt);

        if constexpr (MESH) {
            // (a2) each vertex's cotangent, from the corner slots of the up
            // to 8 voxels whose drag read it, over the vertex's weight (the
            // occupied voxels it averages)
            float* cvert = vfield;  // the vertex field is read no more
            each_rank(pt, [&](int rk) {
                for (int c = first(rk) + threadIdx.x; c < last(rk); c += T) {
                    const int c3[3] = {c / YZ, (c / Z) % Y, c % Z};
                    F3 acc = {0.f, 0.f, 0.f};
                    float wsum = 0.f;
                    for (int kk = 7; kk >= 0; --kk) {
                        const int e[3] = {(kk >> 2) & 1, (kk >> 1) & 1, kk & 1};
                        if (c3[0] < e[0] || c3[1] < e[1] || c3[2] < e[2]) continue;
                        const int u = c - (e[0] * strides[0] + e[1] * strides[1] + e[2]);
                        acc.x += ck[(size_t)(3 * kk) * V + u];
                        acc.y += ck[(size_t)(3 * kk + 1) * V + u];
                        acc.z += ck[(size_t)(3 * kk + 2) * V + u];
                        if (BCH(B_OCC)[u] > 0.5f) wsum += 1.f;
                    }
                    const float w = fmaxf(wsum, 1.f);
                    cvert[c] = acc.x / w; cvert[V + c] = acc.y / w; cvert[2 * V + c] = acc.z / w;
                }
            });
            b4_sync(pt);
            // (a3) each occupied voxel's corners: pos + R(q) off, off[a] =
            // +-L/2 (1 + strain); the strain of its own +a bond where the
            // corner looks along +a, else the far side of the bond below it
            const float* sv = si + (size_t)NT * V;
            float* cs = ck;  // [6][V]: the corner slots are read no more
            each_rank(pt, [&](int rk) {
                for (int u = first(rk) + threadIdx.x; u < last(rk); u += T) {
                    float c_own[3] = {0.f, 0.f, 0.f}, c_below[3] = {0.f, 0.f, 0.f};
                    if (BCH(B_OCC)[u] > 0.5f) {
                        const int u3[3] = {u / (Y * Z), (u / Z) % Y, u % Z};
                        const int dims[3] = {X, Y, Z};
                        const Q qu = {SCH(S_QUAT)[u], SCH(S_QUAT + 1)[u], SCH(S_QUAT + 2)[u],
                                      SCH(S_QUAT + 3)[u]};
                        F3 c_p = {0.f, 0.f, 0.f};
                        Q c_q = {0.f, 0.f, 0.f, 0.f};
                        for (int k = 0; k < 8; ++k) {
                            const int e[3] = {(k >> 2) & 1, (k >> 1) & 1, k & 1};
                            if (u3[0] + e[0] >= dims[0] || u3[1] + e[1] >= dims[1] ||
                                u3[2] + e[2] >= dims[2])
                                continue;
                            const int c = u + e[0] * strides[0] + e[1] * strides[1] + e[2];
                            const F3 g = {cvert[c], cvert[V + c], cvert[2 * V + c]};
                            float off[3], sgn[3];
                            for (int a = 0; a < 3; ++a) {
                                sgn[a] = e[a] ? half_l : -half_l;
                                const float strain =
                                    e[a] ? sv[(size_t)a * V + u]
                                         : (u3[a] > 0 ? sv[(size_t)(3 + a) * V + u - strides[a]] : 0.f);
                                off[a] = sgn[a] * (1.f + strain);
                            }
                            add3(c_p, g);
                            F3 c_off = {0.f, 0.f, 0.f};
                            qrot_vjp(qu, {off[0], off[1], off[2]}, g, c_q, c_off);
                            const float co[3] = {c_off.x * sgn[0], c_off.y * sgn[1], c_off.z * sgn[2]};
                            for (int a = 0; a < 3; ++a) {
                                if (e[a]) c_own[a] += co[a];
                                else if (u3[a] > 0) c_below[a] += co[a];
                            }
                        }
                        COT(S_POS)[u] += c_p.x; COT(S_POS + 1)[u] += c_p.y;
                        COT(S_POS + 2)[u] += c_p.z;
                        COT(S_QUAT)[u] += c_q.w; COT(S_QUAT + 1)[u] += c_q.x;
                        COT(S_QUAT + 2)[u] += c_q.y; COT(S_QUAT + 3)[u] += c_q.z;
                    }
                    for (int a = 0; a < 3; ++a) {
                        cs[(size_t)a * V + u] = c_own[a];
                        cs[(size_t)(3 + a) * V + u] = c_below[a];
                    }
                }
            });
            b4_sync(pt);
        }

        // (b) bond pass, a bond item (v, d) a thread, d-major (neighbouring
        // threads, neighbouring voxels): tf += f1 (own) + f2 (from the lower
        // neighbour), tm -= m1 + m2 likewise. Each bond leaves what it sends
        // its own voxel in its own slab row and what it sends v + stride_d in
        // nbc; a bond along x from a block's last plane reads its far end's
        // cotangents in the next block's slab.
        each_rank(pt, [&](int rk) {
            float* sl = b4_slab(pt, rk);
            const float* up = rk + 1 < pt.C ? b4_slab(pt, rk + 1) : nullptr;
            const int v0 = first(rk), nv = last(rk) - v0;
            for (int it = threadIdx.x; it < 3 * nv; it += T) {
                const int d = it / nv;
                const int lv = it - d * nv;
                const int v = v0 + lv;
                const float* bd = bo + (size_t)(B_DIR + d * B_PER_DIR) * V + v;
                float* nb = sl + (size_t)(6 + d * NB) * Vs + lv;
                float* ow = sl + (size_t)(6 + (3 + d) * NB) * Vs + lv;
                float* c_lp2 = COT(S_LP2 + 3 * d) + v;
                float* c_la1 = COT(S_LA1 + 3 * d) + v;
                float* c_la2 = COT(S_LA2 + 3 * d) + v;
                if (!(bd[(size_t)D_MASK * V] > 0.5f)) {
                    // no bond: its memory is reset to zeros every step
                    for (int c = 0; c < NB; ++c) {
                        nb[(size_t)c * Vs] = 0.f;
                        ow[(size_t)c * Vs] = 0.f;
                    }
                    for (int c = 0; c < 3; ++c) {
                        c_lp2[(size_t)c * V] = 0.f;
                        c_la1[(size_t)c * V] = 0.f;
                        c_la2[(size_t)c * V] = 0.f;
                    }
                    COT(S_MAXS + d)[v] = 0.f;
                    continue;
                }
                const int n = v + strides[d];
                const float* cn = lv + strides[d] < nv ? sl : up;  // n's slab
                const int ln = lv + strides[d] < nv ? lv + strides[d] : lv + strides[d] - nv;
                Bond bn;
                // (the facet drag's material instance) the per-side strains
                // of the stress equalization and their slopes
                float sides[4];
                if constexpr (MAT)  // stiff: the nonlinear stress's slope at the strain
                    bn = bond_forward<true, false, true, VARIANT>(si, bd, v, n, d, V, p, dt,
                                                                  dt_inv, ma, flags, nullptr,
                                                                  nullptr, nullptr, sides);
                else
                    bn = bond_forward(si, bd, v, n, d, V, p, dt, dt_inv);
                float g_strain = 0.f;
                if constexpr (MESH) {
                    // the two sides' strains of the mesh's corners: the
                    // linear fixed point of the stress equalization
                    const float* cs = ck;
                    const float c_s1 = cs[(size_t)d * V + v], c_s2 = cs[(size_t)(3 + d) * V + n];
                    const float E1 = bd[(size_t)D_E1 * V], E2 = bd[(size_t)D_E2 * V];
                    const float s_sum = E1 + E2;
                    const bool hom = (bd[(size_t)D_HOM * V] > 0.5f) ||
                                     fabsf(E1 - E2) <= p.near_eq * fabsf(s_sum);
                    g_strain = hom ? c_s1 + c_s2
                                   : 2.f * sdiv(E2, s_sum) * c_s1 + 2.f * sdiv(E1, s_sum) * c_s2;
                    // with nonlinear materials: through the 3-iteration stress
                    // equalization (the derivative of _bond_dir's sv1k, sv2k)
                    if constexpr (MAT)
                        if (flags & F_NONLINEAR) g_strain = c_s1 * sides[2] + c_s2 * sides[3];
                }
                const float* ctm = sl + 3 * Vs;
                const float* ctmn = cn + 3 * Vs;
                const F3 gF1 = {sl[lv], sl[Vs + lv], sl[2 * Vs + lv]};
                const F3 gF2 = {cn[ln], cn[Vs + ln], cn[2 * Vs + ln]};
                const F3 gM1 = {-ctm[lv], -ctm[Vs + lv], -ctm[2 * Vs + lv]};
                const F3 gM2 = {-ctmn[ln], -ctmn[Vs + ln], -ctmn[2 * Vs + ln]};
                const F3 g_lp2 = {c_lp2[0], c_lp2[V], c_lp2[2 * V]};
                const F3 g_la1 = {c_la1[0], c_la1[V], c_la1[2 * V]};
                const F3 g_la2 = {c_la2[0], c_la2[V], c_la2[2 * V]};
                const BondCot bc = bond_vjp<VARIANT>(bn, bd, d, V, p, dt_inv, SCH(S_MAXS + d)[v],
                                                     gF1, gM1, gF2, gM2, g_lp2, g_la1, g_la2,
                                                     COT(S_MAXS + d)[v], g_strain);
                ow[0] = bc.p1.x; ow[(size_t)Vs] = bc.p1.y; ow[(size_t)2 * Vs] = bc.p1.z;
                ow[(size_t)3 * Vs] = bc.qa.w; ow[(size_t)4 * Vs] = bc.qa.x;
                ow[(size_t)5 * Vs] = bc.qa.y; ow[(size_t)6 * Vs] = bc.qa.z;
                ow[(size_t)7 * Vs] = bc.s1;
                nb[0] = bc.p2.x; nb[(size_t)Vs] = bc.p2.y; nb[(size_t)2 * Vs] = bc.p2.z;
                nb[(size_t)3 * Vs] = bc.qb.w; nb[(size_t)4 * Vs] = bc.qb.x;
                nb[(size_t)5 * Vs] = bc.qb.y; nb[(size_t)6 * Vs] = bc.qb.z;
                nb[(size_t)7 * Vs] = bc.s2;
                c_lp2[0] = bc.lp2.x; c_lp2[V] = bc.lp2.y; c_lp2[2 * V] = bc.lp2.z;
                c_la1[0] = bc.la1.x; c_la1[V] = bc.la1.y; c_la1[2 * V] = bc.la1.z;
                c_la2[0] = bc.la2.x; c_la2[V] = bc.la2.y; c_la2[2 * V] = bc.la2.z;
                COT(S_MAXS + d)[v] = bc.maxs;
            }
        });
        b4_sync(pt);

        // (c) each voxel adds what its own three bonds sent it (summed over
        // d from zero, then added at once: a masked bond's zeros change no
        // bit of a sum that starts at +0), then what its lower neighbours'
        // bonds sent it, a bond along x from the block below through that
        // block's slab
        each_rank(pt, [&](int rk) {
            const float* sl = b4_slab(pt, rk);
            const float* dn = rk > 0 ? b4_slab(pt, rk - 1) : nullptr;
            const int v0 = first(rk);
            for (int v = v0 + threadIdx.x; v < last(rk); v += T) {
                const int lv = v - v0;
                const int coord[3] = {v / YZ, (v / Z) % Y, v % Z};
                float own[NB] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                for (int d = 0; d < 3; ++d) {
                    const float* ow = sl + (size_t)(6 + (3 + d) * NB) * Vs + lv;
                    for (int c = 0; c < NB; ++c) own[c] += ow[(size_t)c * Vs];
                }
                for (int c = 0; c < 7; ++c) COT(S_POS + c)[v] += own[c];
                COT(S_SCALE)[v] += own[7];
                float acc[NB] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                for (int d = 0; d < 3; ++d) {
                    if (coord[d] == 0) continue;
                    const int lu = lv - strides[d];
                    // the lower block holds `planes` whole planes
                    const float* nb = (lu >= 0 ? sl + lu : dn + lu + Vs) + (size_t)(6 + d * NB) * Vs;
                    for (int c = 0; c < NB; ++c) acc[c] += nb[(size_t)c * Vs];
                }
                for (int c = 0; c < 7; ++c) COT(S_POS + c)[v] += acc[c];
                COT(S_SCALE)[v] += acc[7];
            }
        });
        // the next step's pass (a) touches only ctf/ctm and each thread's
        // own voxels; its barrier orders pass (c) before the next pass (b)
    }
    // no block leaves while another may still read its slab
    b4_sync(pt);
#undef SCH
#undef BCH
#undef COT
}

#ifndef EVOSORO_HOST_EMULATION
// The body of every B4 kernel: robot blockIdx.x / C, rank blockIdx.x % C of
// its cluster of C blocks, each owning `planes` x-planes. GMEM: the
// recompute's buffer is the robot's row of gbuf (gstride floats apart) in
// device memory, else dynamic shared memory. The slabs (`slab` floats a
// block) lie in dynamic shared memory where sbuf is null, else in sbuf,
// C slabs a robot.
template <int VARIANT, bool MAT, bool GMEM>
__device__ inline void b4_robot(const float* state_all, const float* body_all, int body_batched,
                                const float* stats_all, const float* ctrl_all, int n_knots,
                                int knot_steps, int step_base, int X, int Y, int Z,
                                int num_steps, const Params& p, int flags, float* tape_all,
                                float* tape_t_all, float* cot_all, float* cot_u_all,
                                float* scr_all, float* gbuf, int gstride, float* sbuf, int C,
                                int planes, int slab, MatArgs ma) {
    extern __shared__ float sh[];
    const int V = X * Y * Z;
    const int b = blockIdx.x / C;
    float* row = gbuf ? gbuf + (size_t)b * gstride : nullptr;
    const B4Part pt = {C, planes, (int)(blockIdx.x % C),
                       sbuf ? sbuf + (size_t)b * C * slab : sh, sbuf ? (size_t)slab : 0};
    ma.bo = body_all + (body_batched ? (size_t)b * C_B * V : 0);
    reverse_segment<VARIANT, MAT>(
        state_all + (size_t)b * C_S * V, ma.bo, stats_all + (size_t)b * C_STAT,
        ctrl_all + (size_t)b * n_knots * V, n_knots, knot_steps, step_base, X, Y, Z, num_steps,
        p, flags, tape_all + (size_t)b * (num_steps + 1) * tape_channels<VARIANT>() * V,
        tape_t_all + (size_t)b * num_steps, cot_all + (size_t)b * C_S * V,
        cot_u_all + (size_t)b * n_knots * V, GMEM ? row : sh, pt,
        scr_all ? scr_all + (size_t)b * B4_MESH_SCR * V : nullptr, MAT ? &ma : nullptr);
}

// The launch of one B4 kernel: B clusters of C blocks (a plain launch when
// C is 1), in the shape b4_shape chose and checked (fused_rollout_bwd.cu).
template <class... E, class... A>
inline int b4_launch(void (*kernel)(E...), int B, int C, int threads, size_t smem,
                     cudaStream_t st, A... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * C, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = C;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = C > 1 ? 1 : 0;
    const int rc = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
    return rc ? rc : (int)cudaGetLastError();
}

#endif
