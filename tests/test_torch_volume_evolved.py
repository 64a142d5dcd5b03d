"""Designs of the volume experiment's first generation, replayed whole and
held against the JAX package.

`bench.volume_experiment` (basic's setup with volume effects, 6^3, 5 s,
collision on) draws its population from a seed, so two of its designs can be
written as `.vxa` files without evaluating the generation: the one the card
scores best (id 14, NormFinalDist ~18.5, eight times basic's best) and one
whose recomputed dt collapses under compression (id 2, still short of its
stop time after the evaluator's two relaunches). Each is replayed through
`bench.replay` with K1's volume instance built for the host by g++
(`emu_fwd_vol`) in place of the card's launch, and held against JAX's jitted
`rollout` in float64 at the port's step count, read from
`tests/fixtures/volume_replays_jax.npz` (`make_volume_replays_jax.py`,
~5 min: the jit and the 20000-step rollouts were 90 % of this file's
time) after checking that JAX ran the same file, step count and dt:

- the best design reaches its stop time in both, with the same step rule,
  the time at rtol 1e-4, the last step's dt (a max over that step's bonds,
  20000 steps in) at rtol 1e-3 and NormFinalDist at rtol 5e-3: its
  distance is the reference's;
- the collapsing design ends short of its stop time in both packages at
  the port's last step count: the collapse is the reference's too. Where
  each ends is not compared: past the collapse the trajectory depends on
  rounding (the JAX package's own float32 and float64 rollouts of it end at
  different times).
"""

import os

import numpy as np
import pytest
from test_torch_b4_host import host_lib  # noqa: F401
from test_torch_volume import _host_vol

from evosoro_tpu_torch import bench
from evosoro_tpu_torch.evo import evaluation
from evosoro_tpu_torch.ops import fused_rollout as fr


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "volume_replays_jax.npz")


def jax_reference(case, path, rec):
    """JAX's stored float64 rollout of replay `case`, after checking that it
    ran the file at `path` at the port's step count and dt."""
    import hashlib

    with np.load(FIXTURE) as f:
        ref = {k.split("/", 1)[1]: f[k][()] for k in f.files if k.startswith(case + "/")}
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == str(ref["vxa_sha256"]), \
            "the stored JAX rollout ran another file: rewrite the fixture"
    assert rec["steps"] == int(ref["steps"]) and rec["dt"] == float(ref["dt"]), \
        "the stored JAX rollout ran another step count or dt: rewrite the fixture"
    return ref


def _design_vxa(ind_id, directory):
    """Design `ind_id` of the volume experiment's first generation, written
    as the evaluator archives a design."""
    sim, env, pop = bench.volume_experiment(pop_size=15)
    ind = next(i for i in pop if i.id == ind_id)
    ind.fitness = 0.0
    evaluation._archive_best(sim, env, ind, str(directory), "volume", 0)
    return next((directory / "bestSoFar" / "fitOnly").glob("*.vxa"))


@pytest.mark.parametrize("ind_id, reaches_stop", [(14, True), (2, False)],
                         ids=["best", "collapsing"])
def test_volume_design_replay_against_jax(host_lib, tmp_path, monkeypatch,  # noqa: F811
                                          ind_id, reaches_stop):
    path = str(_design_vxa(ind_id, tmp_path))
    monkeypatch.setattr(fr, "fused_call", lambda *args, num_steps, **kw: _host_vol(
        host_lib, args, kw, num_steps))
    rec = bench.replay(path, device="cpu")

    from evosoro_tpu_torch.io.vxa import load_vxa

    doc = load_vxa(path)
    assert doc.sim.volume_effects_enabled
    stop = float(doc.sim.stop_condition_value)
    ref = jax_reference("best" if reaches_stop else "collapsing", path, rec)
    assert not rec["diverged"] and not bool(ref["diverged"])
    if reaches_stop:
        assert rec["short"] == 0
        np.testing.assert_allclose(rec["final_t"], float(ref["final_time"]), rtol=1e-4)
        np.testing.assert_allclose(rec["dt_final"], float(ref["cur_dt"]), rtol=1e-3)
        np.testing.assert_allclose(rec["fitness"], float(ref["norm_final_dist"]), rtol=5e-3)
        assert rec["fitness"] > 10.0
    else:
        assert rec["launches"] == 3 and rec["short"] == 1
        assert rec["final_t"] < 0.999 * stop and float(ref["final_time"]) < 0.999 * stop
