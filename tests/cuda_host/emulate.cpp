// The rollout kernels compiled for the host: every device function of
// fused_rollout_common.cuh and fused_rollout_bwd.cu runs as one thread a
// block over the stand-ins of cuda_runtime.h (in this directory), one robot
// after the other. tests/test_torch_b4_host.py and test_torch_k1_host.py
// build this with g++ and hold it against the plain PyTorch versions, so the
// hand-written adjoint and the step's fluid and development variants are
// checked where there is no card; and K1's material instance
// (test_torch_materials.py), its volume instance (test_torch_volume.py),
// B4's material instance (test_torch_b4_host.py), each in every variant
// (test_torch_mat_variants_host.py), and the pair pass of
// pair_contact.cuh, alone (emu_pair: K2; emu_pair_alone: K1's pass on a
// dense or a compact table) and inside K1 (emu_fwd_contact, and emu_fwd_vol
// with either table; tests/test_torch_pair_host.py,
// tests/test_torch_compact_host.py). K1's entry points run k1_step.cuh's step
// loop in place, with the state resident, or (emu_set_step) in the tape form
// B4 recomputes with, so the three can be held bit for bit
// (tests/test_torch_k1_host.py). B4 (emu_bwd) runs a cluster of C blocks a
// robot, one thread standing for all of them (fused_rollout_bwd.cuh
// each_rank), so the split of the sweep over blocks is held here too.
#define EVOSORO_HOST_EMULATION
#include <cstdlib>
#include <vector>

#include "fused_rollout_bwd.cu"
#include "k1_step.cuh"
#include "pair_contact_compact.cu"

// The step loop K1's entry points below run: 0, k1_steps in its tape form
// (B4's recompute) on a tape of whole-state slots, each first holding the
// start state, the robot's state then taken from the slot of its last step;
// 1, k1_steps on the state in place; 2, k1_steps with the state resident
// past the buffer
static int emu_step = 1;
extern "C" void emu_set_step(int mode) { emu_step = mode; }
// mode 0's clocks and steps taken, robot after robot, since the last call
static std::vector<float> emu_clock;
static std::vector<int> emu_taken;
// copies them out: clock (robots x num_steps, unwritten past a robot's
// steps taken), taken (robots); returns the robots
extern "C" int emu_tape_clock(float* clock, int* taken, int num_steps) {
    const int B = (int)emu_taken.size();
    for (int b = 0; b < B; ++b) {
        taken[b] = emu_taken[b];
        for (int i = 0; i < emu_taken[b]; ++i)
            clock[(size_t)b * num_steps + i] = emu_clock[(size_t)b * num_steps + i];
    }
    emu_clock.clear();
    emu_taken.clear();
    return B;
}

// K1's block size and its kernels' bound (k1_step.cuh), as the card's
// launcher takes them (tests/test_torch_big_body.py)
extern "C" int emu_k1_threads(int V, int mat, int pass, int feat) {
    return k1_threads(V, mat != 0, pass != 0, feat != 0);
}
extern "C" int emu_k1_bound(int mat, int pass, int feat) {
    return k1_bound(mat != 0, pass != 0, feat != 0);
}

// floats of an emulated block's buffer: the largest K1 takes at V, and the
// state's copy
static size_t emu_buffer_floats(int V) { return k1_buffer_floats(V, true, 0) + (size_t)C_S * V; }

template <int VARIANT, bool FEAT, bool MAT = false, bool VOL = false, bool DENSE = false,
          bool COMPACT = false>
static void emu_steps(float* st, const float* bo, const float* a1, const float* cu, int n_knots,
                      int knot_steps, int step_base, int X, int Y, int Z, int num_steps,
                      const Params& p, int flags, Robot& r, float* sh, float* scr, Feat* fe,
                      const FeatParams* fp, const MatArgs* ma, float* ke, const VolArgs* va) {
    if (emu_step == 0) {
        const int V = X * Y * Z;
        const size_t slot = (size_t)C_S * V;
        std::vector<float> tape((size_t)(num_steps + 1) * slot), sides(tape.size()),
            clock(num_steps > 0 ? num_steps : 1);
        for (int i = 0; i <= num_steps; ++i) memcpy(&tape[i * slot], st, slot * sizeof(float));
        int n = 0;
        k1_steps<VARIANT, FEAT, MAT, VOL, DENSE, false, true, COMPACT>(
            tape.data(), bo, a1, cu, n_knots, knot_steps, step_base, X, Y, Z, num_steps, p,
            flags, r, sh, sides.data(), fe, fp, ma, ke, va, K1Tape{slot, clock.data(), &n});
        memcpy(st, &tape[(size_t)n * slot], slot * sizeof(float));
        emu_clock.insert(emu_clock.end(), clock.begin(), clock.begin() + num_steps);
        emu_taken.push_back(n);
    } else if (emu_step == 1)
        k1_steps<VARIANT, FEAT, MAT, VOL, DENSE, false, false, COMPACT>(
            st, bo, a1, cu, n_knots, knot_steps, step_base, X, Y, Z, num_steps, p, flags, r, sh,
            scr, fe, fp, ma, ke, va);
    else if constexpr (!MAT || VARIANT == V_LAND)
        k1_steps<VARIANT, FEAT, MAT, VOL, DENSE, true, false, COMPACT>(
            st, bo, a1, cu, n_knots, knot_steps, step_base, X, Y, Z, num_steps, p, flags, r, sh,
            scr, fe, fp, ma, ke, va);
    else  // the material instances in water and with growth have no resident half
        abort();
}
template <int VARIANT, bool FEAT>
static void emu_fwd_variant(float* state, const float* body, int body_batched, float* stats,
                            const float* ctrl, int n_knots, int knot_steps, int step_base,
                            int B, int X, int Y, int Z, int num_steps, const Params& p,
                            int flags, const FeatParams& fp, const float* a1 = nullptr,
                            int a1_batched = 0) {
    const int V = X * Y * Z;
    std::vector<float> sh(emu_buffer_floats(V)), scr((size_t)6 * V);
    for (int b = 0; b < B; ++b) {
        float* stat = stats + (size_t)b * C_STAT;
        Robot r = load_robot(stat);
        Feat fe = load_feat(stat);
        // the dense pass's instance when handed a table with contact on (k1_dense)
        const auto run = k1_dense(flags, a1 != nullptr)
                             ? emu_steps<VARIANT, FEAT, false, false, true>
                             : emu_steps<VARIANT, FEAT>;
        run(state + (size_t)b * C_S * V, body + (body_batched ? (size_t)b * C_B * V : 0),
            a1 ? a1 + (a1_batched ? (size_t)b * V * V : 0) : nullptr,
            n_knots ? ctrl + (size_t)b * n_knots * V : nullptr, n_knots, knot_steps, step_base,
            X, Y, Z, num_steps, p, flags, r, sh.data(), scr.data(), &fe, &fp, nullptr,
            nullptr, nullptr);
        if (FEAT) store_feat(stat, fe, fp, flags);
        stat[ST_TIME] = r.t; stat[ST_DIV] = r.div ? 1.f : 0.f;
        stat[ST_INICM] = r.ini.x; stat[ST_INICM + 1] = r.ini.y; stat[ST_INICM + 2] = r.ini.z;
        stat[ST_CAPT] = r.capt ? 1.f : 0.f;
    }
}
// K1's step loop in place, in the variant the flags select (with the
// features when a feature bit or a source is on), without the pair pass
// (its warp-wide row walk needs 32 lanes)
extern "C" void emu_fwd(float* state, const float* body, int body_batched, float* stats,
                        const float* ctrl, int n_knots, int knot_steps, int step_base, int B,
                        int X, int Y, int Z, int num_steps, const float* params, int flags,
                        const float* fparams) {
    Params p; memcpy(&p, params, sizeof(float) * N_PARAMS);
    const FeatParams fp = feat_params_from(fparams);
    const bool feat = (flags & F_FEAT) || fp.n_src > 0;
#define RUN(VARIANT)                                                                         \
    (feat ? emu_fwd_variant<VARIANT, true>(state, body, body_batched, stats, ctrl, n_knots, \
                                           knot_steps, step_base, B, X, Y, Z, num_steps, p, \
                                           flags, fp)                                       \
          : emu_fwd_variant<VARIANT, false>(state, body, body_batched, stats, ctrl, n_knots, \
                                            knot_steps, step_base, B, X, Y, Z, num_steps, p, \
                                            flags, fp))
    switch (variant_of(flags)) {
        case V_FLUID_FACE: RUN(V_FLUID_FACE); break;
        case V_FLUID_MESH: RUN(V_FLUID_MESH); break;
        case V_DEVO: RUN(V_DEVO); break;
        default: RUN(V_LAND);
    }
#undef RUN
}
// K1's step loop as emu_fwd, with the dense pair pass on the table a1 (B or
// 1, V, V): the land variant, or the variant the flags select
extern "C" void emu_fwd_contact(float* state, const float* body, int body_batched,
                                float* stats, const float* ctrl, int n_knots, int knot_steps,
                                int step_base, int B, int X, int Y, int Z, int num_steps,
                                const float* params, int flags, const float* fparams,
                                const float* a1, int a1_batched) {
    Params p; memcpy(&p, params, sizeof(float) * N_PARAMS);
    const FeatParams fp = feat_params_from(fparams);
    const bool feat = (flags & F_FEAT) || fp.n_src > 0;
#define RUN(VARIANT)                                                                          \
    (feat ? emu_fwd_variant<VARIANT, true>(state, body, body_batched, stats, ctrl, n_knots,  \
                                           knot_steps, step_base, B, X, Y, Z, num_steps, p,  \
                                           flags, fp, a1, a1_batched)                        \
          : emu_fwd_variant<VARIANT, false>(state, body, body_batched, stats, ctrl, n_knots, \
                                            knot_steps, step_base, B, X, Y, Z, num_steps, p, \
                                            flags, fp, a1, a1_batched))
    switch (variant_of(flags)) {
        case V_FLUID_FACE: RUN(V_FLUID_FACE); break;
        case V_FLUID_MESH: RUN(V_FLUID_MESH); break;
        case V_DEVO: RUN(V_DEVO); break;
        default: RUN(V_LAND);
    }
#undef RUN
}
// K2's two launches (pair_contact.cu): a block for each table and row group
// reads its rows into the table's tile mask and active bits; then a block
// of 8 warps for each robot and 2 row groups copies them, stages the boxes
// and runs the pass over its groups, their hot tiles split over its warps.
// pos (B, 3, V), scale (B, V), a1 (B or 1, V, V), out (B, 3, V); margin:
// the cull's; counts: null or 3 words of tile counts (evaluated, culled by
// distance, culled statically), added to
extern "C" void emu_pair(const float* pos, const float* scale, const float* a1, float* out,
                         int B, int V, int a1_batched, float margin, unsigned* counts) {
    const int warps = 8, per_block = 2;
    const int G = pair_groups(V), n = pair_table_words(V), T = a1_batched ? B : 1;
    std::vector<unsigned> tables((size_t)T * n, 0u);
    for (int t = 0; t < T; ++t)
        for (int g = 0; g < G; ++g)
            pair_tile_mask(a1 + (size_t)t * V * V, V, tables.data() + (size_t)t * n, 32 * g,
                           32 * g + 32 < V ? 32 * g + 32 : V);
    std::vector<float> sh((size_t)pair_stage_floats(V) + pair_aux_floats(V) + warps * 96);
    float* sp = sh.data();
    float* aux = sp + pair_stage_floats(V);
    float* partial = aux + pair_aux_floats(V);
    for (int b = 0; b < B; ++b) {
        const float* p = pos + (size_t)b * 3 * V;
        for (int g0 = 0; g0 < G; g0 += per_block) {
            memcpy(pair_mask(aux, G), tables.data() + (size_t)(a1_batched ? b : 0) * n,
                   sizeof(unsigned) * n);
            pair_stage(p, p + V, p + 2 * V, scale + (size_t)b * V, V, sp, aux);
            pair_contact_block(sp, a1 + (a1_batched ? (size_t)b * V * V : 0), V, aux,
                               out + (size_t)b * 3 * V, V, g0, g0 + per_block < G ? g0 + per_block : G,
                               partial, 1.f + margin, counts, warps);
        }
    }
}
// K1's pair pass alone, as its step runs it (pair_contact_compact.cu
// pair_pass_alone): on the compact tables (B or 1, S + 1, S) with S > 0
// (the compact pass's own launch), else on the dense tables (B or 1, V, V);
// a warp owns each of its row groups. pos (B, 3, V), scale (B, V), out (B,
// 3, V); counts: null or 3 words of tile counts, added to
extern "C" void emu_pair_alone(const float* pos, const float* scale, const float* table,
                               float* out, int B, int V, int S, int table_batched, float margin,
                               unsigned* counts) {
    const int N = S > 0 ? S : V;
    const size_t tab = S > 0 ? (size_t)(S + 1) * S : (size_t)V * V;
    std::vector<float> sh((size_t)pair_stage_floats(N) + pair_aux_floats(N));
    for (int b = 0; b < B; ++b) {
        const auto run = S > 0 ? pair_pass_alone<true> : pair_pass_alone<false>;
        run(pos + (size_t)b * 3 * V, scale + (size_t)b * V,
            table + (table_batched ? (size_t)b * tab : 0), V, S, sh.data(),
            out + (size_t)b * 3 * V, 1.f + margin, counts, 16);
    }
}
// The variant the flags select, as the card's launchers pick it: RUN(V) is
// expanded with V the variant's template argument
#define EMU_BY_VARIANT(flags, RUN)                        \
    switch (variant_of(flags)) {                          \
        case V_FLUID_FACE: RUN(V_FLUID_FACE); break;      \
        case V_FLUID_MESH: RUN(V_FLUID_MESH); break;      \
        case V_DEVO: RUN(V_DEVO); break;                  \
        default: RUN(V_LAND);                             \
    }
// ... for the material and volume instances. Their water and growth
// variants build only with EMU_MAT_VARIANTS (the g++ build takes twice as
// long with them, tests/test_torch_mat_variants_host.py); without it a
// launch of theirs aborts.
#ifdef EMU_MAT_VARIANTS
#define EMU_MAT_BY_VARIANT(flags, RUN) EMU_BY_VARIANT(flags, RUN)
#else
#define EMU_MAT_BY_VARIANT(flags, RUN)           \
    if (variant_of(flags) != V_LAND) abort();    \
    RUN(V_LAND);
#endif
// K1's material instance in the variant the flags select (with the
// features when a feature bit or a source is on), without the pair pass:
// ss, the MDL_DATA tables (B or 1, 2P + 3, V) or null; bc, the BC channels
// (B or 1, 15, V) or null; mparams, the clamp's largest displacement a step
template <int VARIANT>
static void emu_fwd_mat_variant(float* state, const float* body, int body_batched, float* stats,
                                int B, int X, int Y, int Z, int num_steps, const Params& p,
                                int flags, const float* fparams, const float* ss, int ss_batched,
                                int n_pts, const float* bc, int bc_batched,
                                const float* mparams) {
    const FeatParams fp = feat_params_from(fparams);
    const bool feat = (flags & F_FEAT) || fp.n_src > 0;
    const int V = X * Y * Z;
    std::vector<float> sh(emu_buffer_floats(V)), scr((size_t)6 * V);
    for (int b = 0; b < B; ++b) {
        float* stat = stats + (size_t)b * C_STAT;
        const float* bo = body + (body_batched ? (size_t)b * C_B * V : 0);
        MatArgs ma = {bo, ss ? ss + (ss_batched ? (size_t)b * (2 * n_pts + 3) * V : 0) : nullptr,
                      bc ? bc + (bc_batched ? (size_t)b * 15 * V : 0) : nullptr, n_pts, 0,
                      mparams[0]};
        float ke[6];
        for (int k = 0; k < 6; ++k) ke[k] = stat[ST_KE + k];
        Robot r = load_robot(stat);
        Feat fe = load_feat(stat);
        float* st = state + (size_t)b * C_S * V;
        if (feat)
            emu_steps<VARIANT, true, true>(st, bo, nullptr, nullptr, 0, 1, 0, X, Y, Z,
                                           num_steps, p, flags, r, sh.data(), scr.data(), &fe,
                                           &fp, &ma, ke, nullptr);
        else
            emu_steps<VARIANT, false, true>(st, bo, nullptr, nullptr, 0, 1, 0, X, Y, Z,
                                            num_steps, p, flags, r, sh.data(), scr.data(),
                                            nullptr, nullptr, &ma, ke, nullptr);
        if (feat) store_feat(stat, fe, fp, flags);
        if (flags & F_EQUIL)
            for (int k = 0; k < 6; ++k) stat[ST_KE + k] = ke[k];
        stat[ST_TIME] = r.t; stat[ST_DIV] = r.div ? 1.f : 0.f;
        stat[ST_INICM] = r.ini.x; stat[ST_INICM + 1] = r.ini.y; stat[ST_INICM + 2] = r.ini.z;
        stat[ST_CAPT] = r.capt ? 1.f : 0.f;
    }
}
extern "C" void emu_fwd_mat(float* state, const float* body, int body_batched, float* stats,
                            int B, int X, int Y, int Z, int num_steps, const float* params,
                            int flags, const float* fparams, const float* ss, int ss_batched,
                            int n_pts, const float* bc, int bc_batched, const float* mparams) {
    Params p; memcpy(&p, params, sizeof(float) * N_PARAMS);
#define RUN(VARIANT)                                                                         \
    emu_fwd_mat_variant<VARIANT>(state, body, body_batched, stats, B, X, Y, Z, num_steps, p, \
                                 flags, fparams, ss, ss_batched, n_pts, bc, bc_batched, mparams)
    EMU_MAT_BY_VARIANT(flags, RUN)
#undef RUN
}
// K1's volume instance (the material instance with VOL; the material
// instance itself when the flags clear the volume bit) in the variant the
// flags select, with the features when a feature bit or a source is on, and
// with the dense pair pass, or the compact one, when a1 is given (one
// thread walks every row); scr, the facet drag's per-side strains
template <int VARIANT, bool FEAT, bool VOL>
static void emu_vol_robot(float* st, const float* bo, const float* a1, int X, int Y, int Z,
                          int num_steps, const Params& p, int flags, Robot& r, float* sh,
                          float* scr, Feat* fe, const FeatParams* fp, const MatArgs* ma,
                          float* ke, const VolArgs* va) {
    const bool table = a1 != nullptr;
    const auto run = k1_dense(flags, table)     ? emu_steps<VARIANT, FEAT, true, VOL, true>
                     : k1_compact(flags, table) ? emu_steps<VARIANT, FEAT, true, VOL, false, true>
                                                : emu_steps<VARIANT, FEAT, true, VOL>;
    run(st, bo, a1, nullptr, 0, 1, 0, X, Y, Z, num_steps, p, flags, r, sh, scr, fe, fp, ma, ke,
        va);
}
template <int VARIANT>
static void emu_fwd_vol_variant(float* state, const float* body, int body_batched, float* stats,
                                const float* a1, int a1_batched, int n_surf, int B, int X,
                                int Y, int Z, int num_steps, const Params& p, int flags,
                                const float* fparams, const float* ss, int ss_batched,
                                int n_pts, const float* bc, int bc_batched,
                                const float* mparams, const float* vparams) {
    const FeatParams fp = feat_params_from(fparams);
    const bool feat = (flags & F_FEAT) || fp.n_src > 0;
    const bool vol = (flags & F_VOL) != 0;
    const int V = X * Y * Z;
    const size_t tab = n_surf > 0 ? (size_t)(n_surf + 1) * n_surf : (size_t)V * V;
    std::vector<float> sh(emu_buffer_floats(V)), vscr((size_t)VOL_SCR * V), scr((size_t)6 * V);
    for (int b = 0; b < B; ++b) {
        float* stat = stats + (size_t)b * C_STAT;
        const float* bo = body + (body_batched ? (size_t)b * C_B * V : 0);
        const float* a1b = a1 ? a1 + (a1_batched ? (size_t)b * tab : 0) : nullptr;
        MatArgs ma = {bo, ss ? ss + (ss_batched ? (size_t)b * (2 * n_pts + 3) * V : 0) : nullptr,
                      bc ? bc + (bc_batched ? (size_t)b * 15 * V : 0) : nullptr, n_pts,
                      (flags & F_COMPACT) ? n_surf : 0, mparams[0]};
        const VolArgs va = {vscr.data(), vparams[0], vparams[1], vparams[2]};
        float ke[6];
        for (int k = 0; k < 6; ++k) ke[k] = stat[ST_KE + k];
        Robot r = load_robot(stat);
        Feat fe = load_feat(stat);
        float* st = state + (size_t)b * C_S * V;
        const auto run = feat ? (vol ? emu_vol_robot<VARIANT, true, true>
                                     : emu_vol_robot<VARIANT, true, false>)
                              : (vol ? emu_vol_robot<VARIANT, false, true>
                                     : emu_vol_robot<VARIANT, false, false>);
        run(st, bo, a1b, X, Y, Z, num_steps, p, flags, r, sh.data(),
            VARIANT == V_FLUID_MESH ? scr.data() : nullptr, feat ? &fe : nullptr,
            feat ? &fp : nullptr, &ma, ke, &va);
        if (feat) store_feat(stat, fe, fp, flags);
        if (flags & F_EQUIL)
            for (int k = 0; k < 6; ++k) stat[ST_KE + k] = ke[k];
        stat[ST_TIME] = r.t; stat[ST_DIV] = r.div ? 1.f : 0.f;
        if (vol) stat[ST_DT] = r.dt;
        stat[ST_INICM] = r.ini.x; stat[ST_INICM + 1] = r.ini.y; stat[ST_INICM + 2] = r.ini.z;
        stat[ST_CAPT] = r.capt ? 1.f : 0.f;
    }
}
extern "C" void emu_fwd_vol(float* state, const float* body, int body_batched, float* stats,
                            const float* a1, int a1_batched, int n_surf, int B, int X, int Y,
                            int Z, int num_steps, const float* params, int flags,
                            const float* fparams, const float* ss, int ss_batched, int n_pts,
                            const float* bc, int bc_batched, const float* mparams,
                            const float* vparams) {
    Params p; memcpy(&p, params, sizeof(float) * N_PARAMS);
#define RUN(VARIANT)                                                                          \
    emu_fwd_vol_variant<VARIANT>(state, body, body_batched, stats, a1, a1_batched, n_surf, B, \
                                 X, Y, Z, num_steps, p, flags, fparams, ss, ss_batched, n_pts, \
                                 bc, bc_batched, mparams, vparams)
    EMU_MAT_BY_VARIANT(flags, RUN)
#undef RUN
}
// K1's material instance in the variant the flags select, without the
// features and tables, with control knots, from its own step base (B4's
// recompute's counterpart in place; tests/test_torch_b4_host.py)
template <int VARIANT>
static void emu_fwd_mat_knots_variant(float* state, const float* body, int body_batched,
                                      float* stats, const float* ctrl, int n_knots,
                                      int knot_steps, int step_base, int B, int X, int Y, int Z,
                                      int num_steps, const Params& p, int flags,
                                      const float* mparams) {
    const int V = X * Y * Z;
    std::vector<float> sh(emu_buffer_floats(V)), scr((size_t)6 * V);
    for (int b = 0; b < B; ++b) {
        float* stat = stats + (size_t)b * C_STAT;
        const float* bo = body + (body_batched ? (size_t)b * C_B * V : 0);
        const MatArgs ma = {bo, nullptr, nullptr, 0, 0, mparams[0]};
        float ke[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        Robot r = load_robot(stat);
        emu_steps<VARIANT, false, true>(state + (size_t)b * C_S * V, bo, nullptr,
                                        ctrl + (size_t)b * n_knots * V, n_knots, knot_steps,
                                        step_base, X, Y, Z, num_steps, p, flags, r, sh.data(),
                                        VARIANT == V_FLUID_MESH ? scr.data() : nullptr,
                                        nullptr, nullptr, &ma, ke, nullptr);
        stat[ST_TIME] = r.t; stat[ST_DIV] = r.div ? 1.f : 0.f;
        stat[ST_INICM] = r.ini.x; stat[ST_INICM + 1] = r.ini.y; stat[ST_INICM + 2] = r.ini.z;
        stat[ST_CAPT] = r.capt ? 1.f : 0.f;
    }
}
extern "C" void emu_fwd_mat_knots(float* state, const float* body, int body_batched,
                                  float* stats, const float* ctrl, int n_knots, int knot_steps,
                                  int step_base, int B, int X, int Y, int Z, int num_steps,
                                  const float* params, int flags, const float* mparams) {
    Params p; memcpy(&p, params, sizeof(float) * N_PARAMS);
#define RUN(VARIANT)                                                                          \
    emu_fwd_mat_knots_variant<VARIANT>(state, body, body_batched, stats, ctrl, n_knots,      \
                                       knot_steps, step_base, B, X, Y, Z, num_steps, p, flags, \
                                       mparams)
    EMU_MAT_BY_VARIANT(flags, RUN)
#undef RUN
}
// B4's cluster rule (fused_rollout_bwd.cuh b4_planes): x-planes a block,
// on a card that holds at_once[C] clusters of C blocks at once (C = 1..8)
extern "C" int emu_b4_planes(int B, int X, int Y, int Z, int threads, int cluster,
                             const int* at_once) {
    return b4_planes(B, X, Y, Z, threads, cluster, [&](int C, int) { return at_once[C]; });
}
// One robot after the other, each as a cluster of C blocks owning `planes`
// x-planes, their slabs in one array (one thread stands for every block:
// each_rank)
template <int VARIANT, bool MAT = false>
static void emu_bwd_variant(const float* state, const float* body, int body_batched,
                            const float* stats, const float* ctrl, int n_knots, int knot_steps,
                            int step_base, int B, int X, int Y, int Z, int num_steps,
                            const Params& p, int flags, float* tape, float* tape_t, float* cot,
                            float* cot_u, int cluster, float max_disp = 0.f) {
    const int V = X * Y * Z;
    const int planes = b4_planes(B, X, Y, Z, 1, cluster, [](int, int) { return 0; });
    const int C = (X + planes - 1) / planes;
    const size_t slab = (size_t)B4_SLAB * planes * Y * Z;
    std::vector<float> buf((size_t)BF * V), slabs(C * slab), scr((size_t)B4_MESH_SCR * V);
    const size_t nt = (size_t)tape_channels<VARIANT>();
    const B4Part pt = {C, planes, 0, slabs.data(), slab};
    for (int b = 0; b < B; ++b) {
        const float* bo = body + (body_batched ? (size_t)b * C_B * V : 0);
        const MatArgs ma = {bo, nullptr, nullptr, 0, 0, max_disp};
        reverse_segment<VARIANT, MAT>(
            state + (size_t)b * C_S * V, bo,
            stats + (size_t)b * C_STAT, ctrl + (size_t)b * n_knots * V, n_knots, knot_steps,
            step_base, X, Y, Z, num_steps, p, flags, tape + (size_t)b * (num_steps + 1) * nt * V,
            tape_t + (size_t)b * num_steps, cot + (size_t)b * C_S * V,
            cot_u + (size_t)b * n_knots * V, buf.data(), pt,
            VARIANT == V_FLUID_MESH ? scr.data() : nullptr, MAT ? &ma : nullptr);
    }
}
// B4 in the variant the flags select, or that variant's material instance
// when the nonlinear or the clamp's bit is on (mparams: the clamp's largest
// displacement a step); tape (B, num_steps + 1, NT or NT_MESH, V);
// cluster: the blocks a robot (b4_planes)
extern "C" void emu_bwd(const float* state, const float* body, int body_batched,
                        const float* stats, const float* ctrl, int n_knots, int knot_steps,
                        int step_base, int B, int X, int Y, int Z, int num_steps,
                        const float* params, int flags, float* tape, float* tape_t, float* cot,
                        float* cot_u, const float* mparams, int cluster) {
    Params p; memcpy(&p, params, sizeof(float) * N_PARAMS);
    if (flags & (F_NONLINEAR | F_MAXVEL)) {
#define RUN_MAT(VARIANT)                                                                       \
    emu_bwd_variant<VARIANT, true>(state, body, body_batched, stats, ctrl, n_knots, knot_steps, \
                                   step_base, B, X, Y, Z, num_steps, p, flags, tape, tape_t,  \
                                   cot, cot_u, cluster, mparams[0])
        EMU_MAT_BY_VARIANT(flags, RUN_MAT)
#undef RUN_MAT
        return;
    }
#define RUN(VARIANT)                                                                          \
    emu_bwd_variant<VARIANT>(state, body, body_batched, stats, ctrl, n_knots, knot_steps,    \
                             step_base, B, X, Y, Z, num_steps, p, flags, tape, tape_t, cot,  \
                             cot_u, cluster)
    EMU_BY_VARIANT(flags, RUN)
#undef RUN
}
