"""Write `b4_water_jax.npz`: the JAX package's kernels on the configuration
of tests/test_torch_fused_diff_fluid.py (`water_case`), in interpret mode
on the CPU, for that file to hold the port against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_b4_water_jax.py

Takes about ten minutes on an 8-core host: the interpret-mode compiles of
the forward kernel, of the backward kernel with the facet drag and of the
fused SQP solve's program. Stores what the kernels were given (the packed
body, the stats rows, the dt and the kernel scalars), the packed start
state, the boundary CoMs and the gradient of the last CoM of robot 0 by the knots through
`DiffRollout`; the inputs and outputs of one backward launch (`_fused_bwd_call`
through the segment's custom vjp) 4 steps in, seg_base 4, with a random
cotangent on the 47 carried channels; and one `sqp_optimize_fused`
iteration's costs and accept decision.
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

from evosoro_tpu.control import sqp as j_sqp  # noqa: E402
from evosoro_tpu.core.rollout import init_state as j_init_state  # noqa: E402
from evosoro_tpu.ops.fused_diff import DiffRollout as JDiffRollout  # noqa: E402
j_fr = sys.modules["evosoro_tpu.ops.fused_rollout"]  # the module, not the function
from test_torch_fused_diff_fluid import (  # noqa: E402
    B,
    C_S_CARRIED,
    FIXTURE,
    K,
    N_SEGS,
    SQP,
    STEPS,
    water_case,
)


def main():
    jb, sim, env, dt, u0 = water_case()
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
    V = int(np.prod(jb.occ.shape))  # the JAX layout pads the voxel axis to 128 lanes
    scalars = j_fr.kernel_scalars(jb.nominal_size, sim, env)
    out = dict(u0=u0, body=np.asarray(jdr.body_packed)[..., :V],
               stats0=np.asarray(jdr.stats0), dt=np.asarray(dt),
               scalars=np.asarray(json.dumps(scalars, sort_keys=True)),
               start=np.asarray(jsp)[..., :V], cms=np.asarray(cms), grad=np.asarray(grad))

    # one backward launch 4 steps in, under random controls
    rng = np.random.default_rng(9)
    S = jdr.seg_steps
    u = rng.uniform(-0.05, 0.05, size=(B, K) + jb.occ.shape).astype(np.float32)
    jctrl = jdr.pack_controls(jnp.asarray(u))
    s4, st4 = jdr._seg(jsp, jdr.stats0, jctrl, jnp.asarray(0, jnp.float32))
    cot = np.zeros((B, jsp.shape[1], jsp.shape[2]), np.float32)
    cot[:, :C_S_CARRIED, :V] = rng.standard_normal((B, C_S_CARRIED, V))
    _, vjp = jax.vjp(lambda s, c: jdr._seg(s, st4, c, jnp.asarray(S, jnp.float32))[0],
                     s4, jctrl)
    cs, cu = vjp(jnp.asarray(cot))
    out.update(bwd_state=np.asarray(s4)[..., :V], bwd_stats=np.asarray(st4).reshape(B, -1),
               bwd_ctrl=np.asarray(jctrl)[..., :V], bwd_seg_base=np.asarray(S),
               bwd_cot=cot[..., :V], bwd_cot_state=np.asarray(cs)[:, :C_S_CARRIED, :V],
               bwd_cot_ctrl=np.asarray(cu)[..., :V])

    _, info = j_sqp.sqp_optimize_fused(
        jb, sim, env, SQP["steps"], SQP["knots"], target=SQP["target"],
        config=j_sqp.SQPConfig(**SQP["cfg"]), dt=dt, n_res=SQP["n_res"], interpret=True)
    out.update(sqp_cost_trace=np.asarray(info["cost_trace"]),
               sqp_final_cost=np.asarray(info["final_cost"]),
               sqp_accepted=np.asarray(info["accepted_trace"]))
    np.savez_compressed(FIXTURE, **out)
    print({k: v.shape for k, v in out.items()})
    print("sqp", out["sqp_cost_trace"], out["sqp_final_cost"], out["sqp_accepted"])


if __name__ == "__main__":
    main()
