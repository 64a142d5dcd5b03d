// K1: fused forward rollout, B robots x num_steps in one launch.
//
// Replaces: evosoro_tpu/ops/fused_rollout.py, _make_kernel (forward branch)
// as launched by _fused_call, restricted to the evolution loop's envelope:
// linear materials, floor with Coulomb friction and the sticky floor,
// gravity, thermal actuation with the mid-life freeze, and self-collision
// through the dense pair pass of pair_contact.cuh (K2); beside it the fluid
// environment (facet drag on the deformed surface mesh, voxel-face drag,
// the land_water actuation) and the linear development ramps, each a
// variant of the step compiled on its own (fused_rollout_common.cuh). The
// host wrapper refuses every other feature flag. It also carries that kernel's MPC
// control-knot channel and segmented mode (:1061, :1119, :1710-1719): step i
// of a launch is global step step_base + i of a rollout whose knot clock
// runs over knot_steps steps; the robot's controls (B, K, V) modulate each
// occupied voxel's scale by u * L after the actuation clamps, with the knot
// min(global step * K / knot_steps, K - 1). The TPU kernel holds the K knot
// rows in on-chip memory and blends them with a one-hot sum; here the
// block computes the knot once a step and each voxel's thread loads its
// value from device memory (the controls of a CEM population stay in L2),
// so the channel costs no shared memory. With K = 0 nothing else changes.
//
// Each step computes what core/step.py:sim_step computes, in the same
// order of operations: three beam-bond passes (small/large-angle
// hysteresis, bond damping, max-strain memory), the force sum with slow
// damping, contact, gravity and floor, the Euler step, moments, the
// angular integration with the quaternion update and its identity snap,
// and the actuation scale update with its clamps. Around it run the
// rollout's bookkeeping of the TPU kernel: the IniCM capture from the
// previous step's positions (seeded at global step 0), the strain > 100
// divergence latch and the per-robot stop-time freeze.
//
// Layout: the packed channel-major tensors of the host side, with V = X*Y*Z
// voxels in flat x-major order and no padding: state (B, 64, V), body
// (B or 1, 88, V), stats (B, 48), pair table (B or 1, V, V).
//
// Design: one block per robot, and the step loop runs inside the kernel,
// so a rollout is one launch and every stencil neighbour lies in the same
// block. Per step: phase A computes each bond (v, d) once, one bond item a
// thread, and keeps its f1, m1 (for v) and f2, m2 (for v + stride_d) in
// shared memory (36 floats a voxel); with collision on, positions and
// scales are staged in shared memory (a float4 a voxel, padded to whole
// 32-voxel groups) beside the pair pass's tile mask and boxes
// (pair_contact.cuh), and the pass writes its forces there too (3 floats
// a voxel; k1_buffer_floats). After a barrier, phase B sums the forces of
// each voxel and integrates it in place, a voxel a thread. Where the buffer
// and the robot's state fit one block's shared memory together (every
// evolution body), the state stays there across the launch. The CoM for
// the IniCM capture and the divergence test are block reductions, each in
// the order a 256-thread block summed them. Frozen robots leave the loop.
// The step itself is k1_step.cuh's k1_steps.
//
// Bound on this card: the latency of one block's step. At 10^3 voxels the
// 144 KB of bond forces leave one block on each SM, and a step took ~40 us
// whether the batch's state fit in L2 (132 robots) or streamed from HBM
// (1024 robots) with 256 threads: the chain of dependent loads and
// barriers within a block set the time, not the bytes. So each kernel
// takes as many threads as its registers allow (k1_bound, one block an
// SM: 512 threads, 384 with the pair pass and the features or materials),
// phase A runs its 3 V bonds one a thread, and
// the state of bodies up to ~540 voxels (~580 without contact) never
// leaves the SM during a launch (k1_step.cuh). With
// collision on, the pair pass (pair_contact.cuh) reads the robot's table
// once a launch for a static tile mask, culls 32 x 32 tiles by their
// groups' boxes every step and walks the hot ones a row a lane, the next
// tile's loads in flight. Every kernel has an instance with the pass
// (DENSE, launched for contact on a dense table: k1_dense) and one
// without, so launches without contact keep their registers (the pass
// takes K1 to 205-255); the material instances have a third, the same pass
// over the S surface voxels of a compact table (COMPACT: k1_compact).
// Shared memory caps V at 1613 cells (1612 in the feature instance, whose
// window ring takes 96 bytes), 1339 with collision; past that the
// device-memory instances (fused_rollout_gmem.cu) run the body.
//
// Numerics: built with -fmad=false and without fast math, so every multiply
// and add rounds as in PyTorch's eager ops and sinf/acosf/sqrtf/division
// are the same IEEE-accurate functions torch uses on the card; the only
// differences from the plain version on the card are the orders of the two
// reductions (CoM, pair forces), which the stated tolerances absorb.
//
// The step's device functions live in fused_rollout_common.cuh, which the
// reverse-mode segment kernel (fused_rollout_bwd.cu) shares; both run
// k1_step.cuh's step loop, B4's recompute in its tape form.
//
// The fitness features (sources, needle, fall-over latch, NormDistByVol,
// speed windows, ballistic development; the JAX kernel's :912-946,
// :1001-1169, :1721-1837) compile into a second instance of each variant,
// launched when a feature bit or a source is on; their carry rides stats
// channels 22-46 and the window ring starts empty in every launch.
//
// Voxelyze's material, solver and boundary options (nonlinear and MDL_DATA
// stress, plasticity, the max-velocity clamp, equilibrium mode, BC regions)
// and the surface-compacted contact pass compile into a kernel of their own,
// fused_rollout_mat_kernel: the land variant's step with the third template
// parameter MAT (and the compact pass in its COMPACT instances), with and
// without the features (the JAX kernel's
// :372-404, :513-573, :907-910, :966-998, :1369-1371, :1519-1605, :734-774),
// launched when any of them is on: the MDL_DATA tables (B or 1, 2P + 3, V)
// and the BC channels (B or 1, 15, V) are read from device memory per voxel,
// the kinetic-energy ring rides stats channels 16-21 and the strain offset
// state channels 53-55. In water and with development the same options run
// in fused_rollout_matvar_kernel<VARIANT, ...> (fused_rollout_matvar.cuh,
// six translation units of their own), where the facet drag's corners read
// the per-side strains of the stress branch that ran. Bound as the land
// step: the stress-equalization loop adds
// 9 material-curve evaluations a bond (each a few loads of the point table
// with MDL_DATA), the ring one block reduction a step.
//
// Volume effects (B6d: the JAX kernel's :1178-1322 and _bond_dir's vol_ctx
// path :440-506, :577) compile into the same kernel's VOL instances
// (fused_rollout_mat_kernel<FEAT, VOL, ...>), so every other instance keeps
// its machine code.
// Per robot it takes a (9, V) scratch in device memory for the coupling's
// two neighbour exchanges (each bond's strain to the voxel pass, each
// voxel's transverse sums and sections back to the bond owners) and the
// stats row's dt as the carried dt (in: the first bond pass's, out: the
// last step's); the coupling carry rides state channels 47-52. Bound as
// the land step, with per step one block max (the dt), one more barrier
// (the voxel pass) and a pow for each free axis of a voxel; its block max
// reuses the reductions' shared scratch.
//
// Bodies past one block's shared memory run the device-memory instances of
// every kernel above (fused_rollout_gmem.cu), launched from this entry when
// the host hands it a buffer.
#include "fused_rollout_k1.cuh"
#include "fused_rollout_matvar.cuh"

// launch_k1<true>: the kernels with the state resident in shared memory
// (fused_rollout_res.cu, a translation unit of its own in the same library)
int launch_res(float* state, const float* body, int body_batched, float* stats,
               const float* a1, int a1_batched, const float* ctrl, int n_knots, int knot_steps,
               int step_base, int B, int X, int Y, int Z, int num_steps, const Params& p,
               int flags, float* scratch, const FeatParams& fp, bool feat, const MatArgs* ma,
               int ss_batched, int bc_batched, const VolArgs* va, int threads,
               cudaStream_t stream);

// launches the device-memory instance the flags select (fused_rollout_gmem.cu,
// a translation unit of its own in the same library)
int launch_gmem(float* state, const float* body, int body_batched, float* stats,
                const float* a1, int a1_batched, const float* ctrl, int n_knots, int knot_steps,
                int step_base, int B, int X, int Y, int Z, int num_steps, const Params& p,
                int flags, float* scratch, const FeatParams& fp, bool feat, const MatArgs* ma,
                int ss_batched, int bc_batched, const VolArgs* va, float* gbuf, int gstride,
                int threads, cudaStream_t st);

// K1's material and volume instances in water and with growth
// (fused_rollout_matvar.cuh), a launcher for each variant in shared memory
// and for its device-memory twins, each in a translation unit of its own
int launch_mat_face(K1_MATVAR_ARGS);
int launch_mat_face_gmem(K1_MATVAR_ARGS);
int launch_mat_mesh(K1_MATVAR_ARGS);
int launch_mat_mesh_gmem(K1_MATVAR_ARGS);
int launch_mat_devo(K1_MATVAR_ARGS);
int launch_mat_devo_gmem(K1_MATVAR_ARGS);

// The material and volume instances in water and with growth
// (fused_rollout_matvar.cuh) have no resident-state half: a speed choice
static bool k1_has_resident_half(int flags) {
    return !((flags & (F_MAT | F_VOL)) && variant_of(flags) != V_LAND);
}

// scratch: (B, 6, V) floats of device memory, needed by the facet-drag
// variant alone (flags F_FLUID | F_FLUID_MESH), else null. fparams: the
// features' N_FEAT_PARAMS constants (ops/fused_rollout.py _feat_params).
// The material instance's inputs: ss, the MDL_DATA tables (B or 1, 2P + 3,
// V) with n_pts = P, or null; bc, the BC channels (B or 1, 15, V), or null;
// n_surf, the surface count of a compact pair table (S + 1, S), or 0;
// mparams, its float constants (ops/fused_rollout.py _mat_params).
// The volume instance's inputs: vscratch, (B, 9, V) floats of device
// memory, and vparams (ops/fused_rollout.py _vol_params); null without the
// volume bit. gbuf: null for the shared-memory instances; else the
// device-memory instances run, robot b's bond buffer at gbuf + b * gstride.
// resident: the state stays in shared memory across the launch
// (ops/fused_rollout.py k1_resident; refused with gbuf), in the instances
// that have a resident-state half (k1_has_resident_half; the others ignore
// it). The block takes k1_threads threads (k1_step.cuh), which
// fused_rollout_k1_threads reports.
extern "C" int fused_rollout(float* state, const float* body, int body_batched,
                             float* stats, const float* a1, int a1_batched,
                             const float* ctrl, int n_knots, int knot_steps,
                             int step_base, int B, int X, int Y, int Z,
                             int num_steps, const float* params, int flags,
                             float* scratch, const float* fparams, const float* ss,
                             int ss_batched, int n_pts, const float* bc, int bc_batched,
                             int n_surf, const float* mparams, float* vscratch,
                             const float* vparams, float* gbuf, int gstride, int resident,
                             void* stream) {
    Params p;
    memcpy(&p, params, sizeof(float) * N_PARAMS);
    const FeatParams fp = feat_params_from(fparams);
    const int variant = variant_of(flags);
    if (variant == V_FLUID_MESH && scratch == nullptr) return (int)cudaErrorInvalidValue;
    // the ballistic rebase lives in the development variant
    if ((flags & F_BALLISTIC) && variant != V_DEVO) return (int)cudaErrorInvalidValue;
    if (fp.n_src < 0 || fp.n_src > MAX_SRC || fp.n_win < 0 || fp.n_win > MAX_WIN)
        return (int)cudaErrorInvalidValue;
    const bool feat = (flags & F_FEAT) || fp.n_src > 0;
    const bool mat = (flags & (F_MAT | F_VOL)) != 0;
    // the material and volume instances need their tables
    if (mat && (((flags & F_MDL) && (ss == nullptr || n_pts < 2)) ||
                ((flags & F_BC) && bc == nullptr) ||
                ((flags & F_COMPACT) && (!(flags & F_COLL) || n_surf <= 0 || a1 == nullptr))))
        return (int)cudaErrorInvalidValue;
    const MatArgs ma = {nullptr, (flags & F_MDL) ? ss : nullptr, (flags & F_BC) ? bc : nullptr,
                        n_pts, (flags & F_COMPACT) ? n_surf : 0, mparams[0]};
    if ((flags & F_VOL) && (vscratch == nullptr || vparams == nullptr))
        return (int)cudaErrorInvalidValue;
    // the state resident only on chip
    if (resident && gbuf) return (int)cudaErrorInvalidValue;
    const int threads = k1_threads(
        X * Y * Z, mat, k1_dense(flags, a1 != nullptr) || k1_compact(flags, a1 != nullptr), feat);
    const VolArgs va = (flags & F_VOL) ? VolArgs{vscratch, vparams[0], vparams[1], vparams[2]}
                                       : VolArgs{nullptr, 0.f, 0.f, 0.f};
    const MatArgs* mp = mat ? &ma : nullptr;
    const VolArgs* vp = (flags & F_VOL) ? &va : nullptr;
    const cudaStream_t s = (cudaStream_t)stream;
    if (mat && variant != V_LAND) {
        const auto go = variant == V_FLUID_FACE ? (gbuf ? launch_mat_face_gmem : launch_mat_face)
                        : variant == V_FLUID_MESH ? (gbuf ? launch_mat_mesh_gmem : launch_mat_mesh)
                                                  : (gbuf ? launch_mat_devo_gmem : launch_mat_devo);
        return go(state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots, knot_steps,
                  step_base, B, X, Y, Z, num_steps, p, flags, scratch, fp, feat, mp, ss_batched,
                  bc_batched, vp, gbuf, gstride, threads, s);
    }
    if (gbuf)
        return launch_gmem(state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots,
                           knot_steps, step_base, B, X, Y, Z, num_steps, p, flags, scratch, fp,
                           feat, mp, ss_batched, bc_batched, vp, gbuf, gstride, threads, s);
    if (resident && k1_has_resident_half(flags))
        return launch_res(state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots,
                          knot_steps, step_base, B, X, Y, Z, num_steps, p, flags, scratch, fp,
                          feat, mp, ss_batched, bc_batched, vp, threads, s);
    return launch_k1<false>(state, body, body_batched, stats, a1, a1_batched, ctrl, n_knots,
                            knot_steps, step_base, B, X, Y, Z, num_steps, p, flags, scratch,
                            fp, feat, mp, ss_batched, bc_batched, vp, threads, s);
}

// 1 where the launch above keeps the state resident when asked (the
// instances with a resident-state half), else 0: ops/fused_rollout.py
// k1_launch_shape reports it
extern "C" int fused_rollout_k1_resident_half(int flags) {
    return k1_has_resident_half(flags) ? 1 : 0;
}

// The threads a block of the launch above takes with these V, flags, pair
// table (a1 given or not) and feature constants: k1_threads
extern "C" int fused_rollout_k1_threads(int V, int flags, int table, const float* fparams) {
    const bool feat = (flags & F_FEAT) || feat_params_from(fparams).n_src > 0;
    return k1_threads(V, (flags & (F_MAT | F_VOL)) != 0,
                      k1_dense(flags, table != 0) || k1_compact(flags, table != 0), feat);
}
