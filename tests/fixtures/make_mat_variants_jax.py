"""Write `mat_variants_jax.npz`: the JAX package on the cases of
tests/test_torch_mat_variants.py, on the CPU, for that file to hold the port
against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_mat_variants_jax.py [face mesh devo]

Takes a few minutes on an 8-core host: three interpret-mode compiles of the
forward kernel (the voxel-face drag with bilinear stress, plasticity, the
clamp and volume effects; the facet drag with bilinear stress; growth with
MDL_DATA, BC regions and the compact contact pass) and three traces of the
jnp rollout's gradient. Stores, per forward case, the moving start state's
momenta, the dt and the packed body the kernel was given and its output
state's fields (for the voxel-face case also JAX's jnp step's, from which
its kernel parts: ROADMAP.md section C); per backward case, the controls,
the kernel scalars, the last CoM-y of robot 0 and `jax.grad` of it by the
knots through the jnp rollout.
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
from evosoro_tpu.core.step import sim_step as j_sim_step  # noqa: E402
import evosoro_tpu.ops.fused_rollout  # noqa: E402,F401
j_fr = sys.modules["evosoro_tpu.ops.fused_rollout"]  # the module, not the function
from test_torch_mat_variants import (  # noqa: E402
    FIELDS,
    FIXTURE,
    STEPS,
    backward_case,
    forward_case,
)


def forward(name, out):
    jb, sim, env, dt, moving, steps = forward_case(name)
    assert j_fr.supports(jb, sim, env), name
    if name == "devo":
        os.environ["EVOSORO_TPU_COLL_COMPACT"] = "1"
    V = int(np.prod(jb.occ.shape))
    Vp = -(-V // 128) * 128
    ref, _ = j_fr.fused_rollout(moving, jb, sim, env, num_steps=steps, dt=jnp.asarray(dt),
                                interpret=True, batch_block=2)
    os.environ.pop("EVOSORO_TPU_COLL_COMPACT", None)
    pre = name + "_fwd_"
    out[pre + "in_linmom"] = np.asarray(moving.linmom)
    out[pre + "dt"] = np.asarray(dt)
    out[pre + "body"] = np.asarray(j_fr._pack_body_jit(jb, Vp, jnp.float32))[..., :V]
    vol = ("ts_sum", "cs_area") if sim.volume_effects_enabled else ()
    for f in FIELDS + vol:
        out[pre + f] = np.asarray(getattr(ref, f))
    print(name, "forward", {f: out[pre + f].shape for f in FIELDS})
    if name == "face":
        # JAX's jnp step on the same state: its kernel takes the volume
        # effects' thermal stress off before plasticity, its jnp step after
        def one(s):
            def step(s, _):
                return j_sim_step(s, jb, sim, env, dt), ()

            return jax.lax.scan(step, s, None, length=steps)[0]

        jnp_out = jax.jit(jax.vmap(one))(moving)
        for f in FIELDS + vol:
            out[name + "_jnp_" + f] = np.asarray(getattr(jnp_out, f))


def backward(name, out):
    jb, sim, env, dt, u0 = backward_case(name)
    state = j_init_state(jb, dtype=jnp.float32)

    def f_jnp(u):
        return j_rollout(jb, sim, env, num_steps=STEPS, dt=dt, state=state,
                         control_sequence=u).final_cm[1]

    y, g = jax.value_and_grad(f_jnp)(jnp.asarray(u0))
    pre = name + "_bwd_"
    out[pre + "u0"] = u0
    out[pre + "scalars"] = np.asarray(json.dumps(j_fr.kernel_scalars(jb.nominal_size, sim, env),
                                                 sort_keys=True))
    out[pre + "final_cm_y"] = np.asarray(y)
    out[pre + "grad_jnp"] = np.asarray(g)
    print(name, "backward", float(y), float(np.abs(np.asarray(g)).max()))


def main(names):
    """Rewrite the cases `names` (all three by default), keeping the
    fixture's others."""
    out = dict(np.load(FIXTURE)) if os.path.exists(FIXTURE) and names else {}
    for name in names or ("face", "mesh", "devo"):
        forward(name, out)
        backward(name, out)
    np.savez_compressed(FIXTURE, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
