"""The port's twin of tools/onchip_parity.py
(`evosoro_tpu_torch.onchip_parity`): its 12 scenario builders give the JAX
tool's bodies, parameters and start states field for field (float32
values exactly, as both packages build them; the JAX tool's objects are
stored in `tests/fixtures/viz_analysis_jax.npz` beside a digest of its
source, `make_viz_analysis_jax.py` rewrites them), one scenario runs on the
CPU, and `check` applies the JAX tool's rule."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from evosoro_tpu_torch import onchip_parity
from jax_outputs import stored

_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                     "onchip_parity.py")
_spec = importlib.util.spec_from_file_location("jax_onchip_parity_tool", _TOOL)
j_onchip_parity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(j_onchip_parity)

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "viz_analysis_jax.npz")


def flat(obj, prefix=""):
    """{dotted field name: numpy value} of a dataclass of either package
    (nested dataclasses flattened, None fields left out)."""
    out = {}
    for f in dataclasses.fields(obj):
        v, key = getattr(obj, f.name), prefix + f.name
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(flat(v, key + "."))
        else:
            out[key] = np.asarray(v.cpu() if torch.is_tensor(v) else v)
    return out


def scenario_inputs(name):
    """What a scenario's stored JAX objects were built from: the JAX tool's
    source and the scenario's name."""
    with open(_TOOL, "rb") as f:
        return np.frombuffer(f.read(), np.uint8), np.frombuffer(name.encode(), np.uint8)


def scenario_jax(name):
    """The JAX tool's body, parameters and start state of a scenario,
    flattened (for the fixture), with its `use_rollout` flag."""
    body, sim, env, kw = j_onchip_parity.SCENARIOS[name](np.random.default_rng(3))
    out = {"body." + k: v for k, v in flat(body).items()}
    for part, obj in (("sim", sim), ("env", env)):
        out.update({f"{part}.{k}": v for k, v in flat(obj).items()})
    if "state" in kw:
        out.update({"state." + k: v for k, v in flat(kw["state"]).items()})
    out["use_rollout"] = np.asarray(bool(kw.get("use_rollout")))
    return out


@pytest.mark.parametrize("name", list(onchip_parity.SCENARIOS))
def test_scenario_builders_match_jax(name):
    """The port's body, parameters and state set the JAX tool's fields and
    no others, each equal to JAX's exactly (JAX's objects stored in the fixture: its eager
    builders take 2-4 s a scenario on the CPU)."""
    assert list(onchip_parity.SCENARIOS) == list(j_onchip_parity.SCENARIOS)
    ref = stored(FIXTURE, "scenario_" + name, *scenario_inputs(name))
    body, sim, env, kw = onchip_parity.scenario(name, device="cpu")
    parts = [("body", body), ("sim", sim), ("env", env)]
    if "state" in kw:
        parts.append(("state", kw["state"]))
    for part, obj in parts:
        got = flat(obj)
        assert got, part
        # both ways: a field JAX sets and the port leaves as None fails too
        assert set(got) == {k[len(part) + 1:] for k in ref if k.startswith(part + ".")}, part
        for k, v in got.items():
            np.testing.assert_array_equal(v, ref[f"{part}.{k}"], err_msg=f"{part}.{k}")
    assert ("state" in kw) == any(k.startswith("state.") for k in ref)
    assert bool(kw.get("use_rollout")) == bool(ref["use_rollout"])


def test_one_scenario_runs_on_the_cpu():
    rec = onchip_parity.run_scenario("default", steps=3, device="cpu")
    assert set(rec) == {"max_abs_pos_diff_m", "max_abs_linmom_diff", "pos_span_m", "diverged"}
    # float32 on the CPU: K1's plain version is the eager step
    assert rec["max_abs_pos_diff_m"] < 1e-7 * rec["pos_span_m"] and not rec["diverged"]
    assert rec["pos_span_m"] > 0.01


def test_check_rule():
    def record(**drifts):
        return {"scenarios": {k: dict(max_abs_pos_diff_m=v, diverged=k == "div")
                              for k, v in drifts.items()}}

    committed = record(a=1e-6, b=0.0, c=1e-6)
    assert onchip_parity.check(record(a=2.9e-6, b=1e-8, c=0.0, new=1.0), committed) == []
    fails = onchip_parity.check(record(a=3.1e-6, b=1.1e-8, c=0.0, div=0.0), committed)
    assert [f.split(":")[0] for f in fails] == ["a", "b", "div"]
    assert onchip_parity.CHECK_MARGIN == j_onchip_parity.CHECK_MARGIN
    assert onchip_parity.CHECK_FLOOR == j_onchip_parity.CHECK_FLOOR
    assert (onchip_parity.STEPS, onchip_parity.BATCH) == (j_onchip_parity.STEPS,
                                                          j_onchip_parity.BATCH)
