// K1's material and volume instances with the development ramps (V_DEVO), in
// shared memory: a translation unit of its own in the fused_rollout library
// (fused_rollout_matvar.cuh).
#include "fused_rollout_matvar.cuh"

K1_MATVAR_UNIT(launch_mat_devo, V_DEVO, false)
