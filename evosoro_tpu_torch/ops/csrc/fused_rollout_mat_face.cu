// K1's material and volume instances with the voxel-face drag (V_FLUID_FACE), in
// shared memory: a translation unit of its own in the fused_rollout library
// (fused_rollout_matvar.cuh).
#include "fused_rollout_matvar.cuh"

K1_MATVAR_UNIT(launch_mat_face, V_FLUID_FACE, false)
