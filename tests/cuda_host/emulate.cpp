// The rollout kernels compiled for the host: every device function of
// fused_rollout_common.cuh and fused_rollout_bwd.cu runs as one thread a
// block over the stand-ins of cuda_runtime.h (in this directory), one robot
// after the other. tests/test_torch_b4_host.py builds this with g++ and
// holds it against the plain PyTorch versions, so the hand-written adjoint
// is checked where there is no card.
#define EVOSORO_HOST_EMULATION
#include <vector>

#include "fused_rollout_bwd.cu"
extern "C" void emu_fwd(float* state, const float* body, int body_batched, float* stats,
                        const float* ctrl, int n_knots, int knot_steps, int step_base, int B,
                        int X, int Y, int Z, int num_steps, const float* params, int flags) {
    Params p; memcpy(&p, params, sizeof(float) * N_PARAMS);
    const int V = X * Y * Z;
    std::vector<float> sh((size_t)(BF + 7) * V);
    for (int b = 0; b < B; ++b) {
        float* stat = stats + (size_t)b * C_STAT;
        Robot r = load_robot(stat);
        rollout_steps(state + (size_t)b * C_S * V, 0, body + (body_batched ? (size_t)b * C_B * V : 0),
                      nullptr, n_knots ? ctrl + (size_t)b * n_knots * V : nullptr, n_knots, knot_steps, step_base,
                      X, Y, Z, num_steps, p, flags, r, nullptr, sh.data());
        stat[ST_TIME] = r.t; stat[ST_DIV] = r.div ? 1.f : 0.f;
        stat[ST_INICM] = r.ini.x; stat[ST_INICM + 1] = r.ini.y; stat[ST_INICM + 2] = r.ini.z;
        stat[ST_CAPT] = r.capt ? 1.f : 0.f;
    }
}
extern "C" void emu_bwd(const float* state, const float* body, int body_batched,
                        const float* stats, const float* ctrl, int n_knots, int knot_steps,
                        int step_base, int B, int X, int Y, int Z, int num_steps,
                        const float* params, int flags, float* tape, float* tape_t, float* cot,
                        float* cot_u) {
    Params p; memcpy(&p, params, sizeof(float) * N_PARAMS);
    const int V = X * Y * Z;
    std::vector<float> sh((size_t)BF * V);
    for (int b = 0; b < B; ++b)
        reverse_segment(state + (size_t)b * C_S * V, body + (body_batched ? (size_t)b * C_B * V : 0),
                        stats + (size_t)b * C_STAT, ctrl + (size_t)b * n_knots * V, n_knots, knot_steps,
                        step_base, X, Y, Z, num_steps, p, flags,
                        tape + (size_t)b * (num_steps + 1) * NT * V, tape_t + (size_t)b * num_steps,
                        cot + (size_t)b * C_S * V, cot_u + (size_t)b * n_knots * V, sh.data());
}
