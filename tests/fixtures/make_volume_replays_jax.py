"""Write `volume_replays_jax.npz`: the JAX package's jitted `rollout` in
float64 on the three volume-effects replays that
tests/test_torch_volume_evolved.py (designs 14 and 2 of the volume
experiment's first generation) and tests/test_torch_volume_replay.py (the
first archived fixture written back with volume effects) hold the port
against.

    JAX_PLATFORMS=cpu python tests/fixtures/make_volume_replays_jax.py

Takes ~5 min on an 8-core host: the jit of each 6^3 rollout with contact
and its ~20000-35000 steps. Each case first replays the file through the
port as its test does (`bench.replay` with K1's volume instance built for the
host by g++), for the step count and dt JAX then runs at, and stores what
JAX was given (the .vxa file's SHA-256, the step count, the dt) beside what
it returned (the final time, the last step's dt, NormFinalDist, the
divergence latch; for the fixture case also JAX's first step count and the
time it reaches). Rewrite it whenever a case, the .vxa writer, the step rule
or either package's volume-effects step changes.
"""

import hashlib
import os
import sys
import tempfile
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the tests

from evosoro_tpu.core.collision import attach_collision_system  # noqa: E402
from evosoro_tpu.core.rollout import init_state as j_init_state  # noqa: E402
from evosoro_tpu.core.rollout import num_steps_for as j_num_steps_for  # noqa: E402
from evosoro_tpu.core.rollout import rollout as j_rollout  # noqa: E402
from evosoro_tpu.io.vxa import load_vxa as j_load_vxa  # noqa: E402
from evosoro_tpu_torch import bench  # noqa: E402
from evosoro_tpu_torch.ops import fused_rollout as fr  # noqa: E402

FIXTURE = os.path.join(HERE, "volume_replays_jax.npz")


def vxa_digest(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def jax_rollout(path, num_steps, dt):
    """JAX's jitted float64 rollout of the .vxa file at `path`."""
    doc = j_load_vxa(path)
    jb = attach_collision_system(doc.build_body(dtype=jnp.float64),
                                 float(doc.sim.collision_horizon))
    stop = float(doc.sim.stop_condition_value)
    return jax.jit(lambda: j_rollout(jb, doc.sim, doc.env, num_steps=num_steps, dt=dt,
                                     state=j_init_state(jb, volume_effects=True),
                                     stop_time=stop))(), jb, doc


def main():
    from test_torch_b4_host import emulation_library
    from test_torch_volume import _host_vol
    from test_torch_volume_evolved import _design_vxa

    lib = emulation_library()
    out = {}
    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(
            fr, "fused_call", lambda *args, num_steps, **kw: _host_vol(lib, args, kw, num_steps)):
        paths = {name: str(_design_vxa(ind, Path(tmp) / name))
                 for name, ind in (("best", 14), ("collapsing", 2))}
        paths["fixture"] = bench.write_volume_vxa(bench.fixture_paths()[0],
                                                  os.path.join(tmp, "volume.vxa"))
        for name, path in paths.items():
            rec = bench.replay(path, device="cpu")
            ref, jb, doc = jax_rollout(path, rec["steps"], rec["dt"])
            case = dict(vxa_sha256=vxa_digest(path), steps=rec["steps"], dt=rec["dt"],
                        final_time=float(ref.final_state.time),
                        cur_dt=float(ref.final_state.cur_dt),
                        norm_final_dist=float(ref.norm_final_dist),
                        diverged=bool(ref.diverged))
            if name == "fixture":
                first = j_num_steps_for(jb, doc.sim, rec["dt"])
                case.update(first_steps=int(first), first_final_time=float(
                    jax_rollout(path, first, rec["dt"])[0].final_state.time))
            out.update({f"{name}/{k}": np.asarray(v) for k, v in case.items()})
            print(name, case, flush=True)
    np.savez_compressed(FIXTURE, **out)


if __name__ == "__main__":
    main()
