"""A `.vxa` replay with volume effects, whole, held against the JAX package.

The first archived fixture (`basic_data/bestSoFar/fitOnly`, 6^3, collision
on, 5 s) written back with VolumeEffectsEnabled set goes through
`bench.replay` (`load_vxa` -> `fused_rollout` -> `locomotion_fitness`,
relaunched longer while it ends short of its stop time) with K1's volume
instance built for the host by g++ (`emu_fwd_vol`) in place of the card's
launch: the plain version takes ~20 ms a step here, the host build ~0.3 ms.
The reference is the JAX package's jitted `rollout` in float64 on the same
file, at the port's step counts, read from
`tests/fixtures/volume_replays_jax.npz` (`make_volume_replays_jax.py`)
after checking that JAX ran the same file, step count and dt:

- the step rule: the 15 % pad of `num_steps_for` ends short of the stop
  time in both packages (the recomputed dt shrinks by more than 15 %), and
  1.5 times as many steps reach it in both;
- the time reached and the last step's dt at rtol 1e-4 (the dt is a max
  over the robot's bonds);
- the fitness, NormFinalDist after 5 s of thermal actuation, at rtol 0.1:
  over 20000 steps float32 rounding moves it by several percent (the JAX
  package's own float32 rollout of this file lies as far from its float64
  one), so the port's float32 run is held to that spread around the
  float64 reference.
"""

import numpy as np
from test_torch_b4_host import host_lib  # noqa: F401
from test_torch_volume import _host_vol
from test_torch_volume_evolved import jax_reference

from evosoro_tpu_torch import bench
from evosoro_tpu_torch.io.vxa import load_vxa
from evosoro_tpu_torch.ops import fused_rollout as fr


def test_volume_fixture_replay_matches_jax(host_lib, tmp_path, monkeypatch):  # noqa: F811
    path = bench.write_volume_vxa(bench.fixture_paths()[0], str(tmp_path / "volume.vxa"))
    monkeypatch.setattr(fr, "fused_call", lambda *args, num_steps, **kw: _host_vol(
        host_lib, args, kw, num_steps))
    rec = bench.replay(path, device="cpu")

    stop = float(load_vxa(path).sim.stop_condition_value)
    ref = jax_reference("fixture", path, rec)
    first = int(ref["first_steps"])  # JAX's num_steps_for at the port's dt
    assert rec["steps"] == int(np.ceil(1.5 * first)) and rec["launches"] == 2
    assert rec["short"] == 0 and not rec["diverged"]
    assert float(ref["first_final_time"]) < 0.999 * stop  # short in JAX too
    assert not bool(ref["diverged"])
    np.testing.assert_allclose(rec["final_t"], float(ref["final_time"]), rtol=1e-4)
    np.testing.assert_allclose(rec["dt_final"], float(ref["cur_dt"]), rtol=1e-4)
    np.testing.assert_allclose(rec["fitness"], float(ref["norm_final_dist"]), rtol=0.1)
