"""Write `b4_materials_jax.npz`: the JAX package's kernels on the
configuration of tests/test_torch_fused_diff_materials.py (`materials_case`:
a bilinear palette with the max-velocity clamp), in interpret mode on the
CPU, for that file to hold the port against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_b4_materials_jax.py

Takes about three minutes on an 8-core host: the interpret-mode compiles of
the forward and backward kernels with the nonlinear stress and the clamp.
Stores what the kernels were given (the packed body, the stats rows, the dt
and the kernel scalars), the packed start state, the boundary CoMs and the
gradient of the last CoM of robot 0 by the knots through `DiffRollout`,
beside `jax.grad` through JAX's jnp rollout (tests/test_fused_diff.py's
reference; it prints the kernel's worst error over the gradient's scale);
and the inputs and outputs of one backward launch (`_fused_bwd_call` through
the segment's custom vjp) from the state 4 steps in with every voxel turned
away from the identity and its momenta perturbed (`perturbed`), seg_base 4,
with a random cotangent on the 47 carried channels.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the tests

from evosoro_tpu.core.rollout import init_state as j_init_state  # noqa: E402
from evosoro_tpu.core.rollout import rollout as j_rollout  # noqa: E402
from evosoro_tpu.ops.fused_diff import DiffRollout as JDiffRollout  # noqa: E402
j_fr = sys.modules["evosoro_tpu.ops.fused_rollout"]  # the module, not the function
from test_torch_fused_diff_materials import (  # noqa: E402
    B,
    C_S_CARRIED,
    FIXTURE,
    K,
    N_SEGS,
    STEPS,
    materials_case,
    perturbed,
)


def main():
    jb, sim, env, dt, u0 = materials_case()
    state = j_init_state(jb, dtype=jnp.float32)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), state)
    jdr = JDiffRollout(jb, sim, env, num_steps=STEPS, num_knots=K, dt=dt, batch=B,
                       n_segs=N_SEGS, interpret=True)
    jsp = jdr.init_packed(batched)

    def last_cm(u):
        cms, _, _ = jdr(jsp, jdr.stats0, jdr.pack_controls(
            jnp.broadcast_to(u[None], (B,) + u.shape)))
        return cms[-1, 0], cms

    (_, cms), grad = jax.value_and_grad(last_cm, has_aux=True)(jnp.asarray(u0))

    # the kernel against JAX's own jnp BPTT, at tests/test_fused_diff.py's bound
    def f_jnp(u):
        return j_rollout(jb, sim, env, num_steps=STEPS, dt=dt, state=state,
                         control_sequence=u).final_cm[1]

    g_jnp = np.asarray(jax.grad(f_jnp)(jnp.asarray(u0)))
    scale = np.abs(g_jnp).max()
    print("kernel vs jnp BPTT: worst |diff| / scale",
          float(np.abs(np.asarray(grad) - g_jnp).max() / scale))

    V = int(np.prod(jb.occ.shape))  # the JAX layout pads the voxel axis to 128 lanes
    scalars = j_fr.kernel_scalars(jb.nominal_size, sim, env)
    out = dict(u0=u0, body=np.asarray(jdr.body_packed)[..., :V],
               stats0=np.asarray(jdr.stats0), dt=np.asarray(dt),
               scalars=np.asarray(json.dumps(scalars, sort_keys=True)),
               start=np.asarray(jsp)[..., :V], cms=np.asarray(cms), grad=np.asarray(grad),
               grad_jnp=g_jnp)

    # one backward launch 4 steps in, under random controls
    rng = np.random.default_rng(9)
    S = jdr.seg_steps
    u = rng.uniform(-0.05, 0.05, size=(B, K) + jb.occ.shape).astype(np.float32)
    jctrl = jdr.pack_controls(jnp.asarray(u))
    s4, st4 = jdr._seg(jsp, jdr.stats0, jctrl, jnp.asarray(0, jnp.float32))
    s4 = jnp.asarray(perturbed(np.asarray(s4), np.asarray(jdr.body_packed), jb.nominal_size))
    cot = np.zeros((B, jsp.shape[1], jsp.shape[2]), np.float32)
    cot[:, :C_S_CARRIED, :V] = rng.standard_normal((B, C_S_CARRIED, V))
    _, vjp = jax.vjp(lambda s, c: jdr._seg(s, st4, c, jnp.asarray(S, jnp.float32))[0],
                     s4, jctrl)
    cs, cu = vjp(jnp.asarray(cot))
    out.update(bwd_state=np.asarray(s4)[..., :V], bwd_stats=np.asarray(st4).reshape(B, -1),
               bwd_ctrl=np.asarray(jctrl)[..., :V], bwd_seg_base=np.asarray(S),
               bwd_cot=cot[..., :V], bwd_cot_state=np.asarray(cs)[:, :C_S_CARRIED, :V],
               bwd_cot_ctrl=np.asarray(cu)[..., :V])
    np.savez_compressed(FIXTURE, **out)
    print({k: v.shape for k, v in out.items()})


if __name__ == "__main__":
    main()
