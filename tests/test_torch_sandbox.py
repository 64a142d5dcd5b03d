"""The port's interactive sandbox (`evosoro_tpu_torch.viz.sandbox`): the
three cases of tests/test_sandbox.py on the port, its state after 5 steps,
a poke and 60 steps held against the JAX package's sandbox in float64 (rtol
1e-9 on positions, 1e-7 on momenta, a poke of 200 N included), and
`record_gif` and the REPL's `g` writing a GIF, which the JAX package's
cannot (ROADMAP section C). JAX's sandbox jits its step (~5 s), so its state
is read from `tests/fixtures/viz_analysis_jax.npz` after checking the
digest of the numpy inputs both packages build the body from
(`make_viz_analysis_jax.py` rewrites it).
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu_torch.core import EnvParams, SimParams, build_body, palette_from_list
from evosoro_tpu_torch.core.types import evosoro_default_palette
from evosoro_tpu_torch.viz.sandbox import InteractiveSandbox, repl
from jax_outputs import stored

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "viz_analysis_jax.npz")
POKE = ((1, 1, 1), (200.0, 0.0, 0.0), 40)


def _structure():
    rng = np.random.default_rng(3)
    s = np.zeros((3, 3, 2), dtype=np.int32)
    s[:, :, 0] = 3
    s[:, :, 1] = 1
    return s, rng.uniform(-1, 1, size=s.shape)


def _sandbox(dtype=torch.float32):
    s, phase = _structure()
    body = build_body(s, palette_from_list(evosoro_default_palette()),
                      phase_offset=phase, dtype=dtype)
    return InteractiveSandbox(body, SimParams(init_cm_time=0.0), EnvParams())


def test_step_poke_reset():
    sb = _sandbox()
    t0 = sb.time
    sb.step(5)
    assert sb.time > t0
    assert sb.steps_done == 5
    cm_before = sb.center_of_mass().copy()

    # a lateral poke imparts momentum the unpoked sim doesn't have
    sb2 = _sandbox().step(5)
    sb2.apply_force(*POKE)
    sb.step(60)
    sb2.step(60)
    assert sb2.center_of_mass()[0] > sb.center_of_mass()[0] + 1e-7
    assert np.isfinite(sb2.center_of_mass()).all()

    sb2.reset()
    assert sb2.time == 0.0
    assert sb2.steps_done == 0
    np.testing.assert_allclose(sb2.center_of_mass(), cm_before, atol=1e-3)


def test_poke_requires_occupied_voxel():
    rng = np.random.default_rng(3)
    s = np.zeros((3, 3, 2), dtype=np.int32)
    s[:, :, 0] = 3
    s[2, 2, 1] = 0  # a hole
    s[0, 0, 1] = 1
    body = build_body(s, palette_from_list(evosoro_default_palette()),
                      phase_offset=rng.uniform(-1, 1, size=s.shape))
    sb = InteractiveSandbox(body, SimParams(), EnvParams())
    with pytest.raises(ValueError):
        sb.apply_force((2, 2, 1), (1, 0, 0))
    sb.apply_force((0, 0, 1), (1, 0, 0))  # occupied: fine


def test_repl_scripted(tmp_path):
    sb = _sandbox()
    png = tmp_path / "frame.png"
    script = io.StringIO(
        "i\n"
        "s 5\n"
        "p 1 1 1 0 0 0.2 5\n"
        "s 10\n"
        "c\n"
        f"r {png}\n"
        "z\n"
        "bogus\n"
        "q\n"
    )
    out = io.StringIO()
    repl(sb, stdin=script, stdout=out)
    text = out.getvalue()
    assert "t=" in text and "rendered" in text and "reset." in text
    assert "unknown command" in text
    assert png.exists() and png.stat().st_size > 0
    assert sb.steps_done == 0  # the z command reset it


def sandbox_inputs():
    s, phase = _structure()
    return s, phase, np.asarray([5, 60, *POKE[0], *POKE[1], POKE[2]], dtype=np.float64)


def sandbox_jax():
    """JAX's sandbox state after 5 steps, the poke and 60 steps (for the
    fixture)."""
    from evosoro_tpu.core.types import EnvParams as JEnv
    from evosoro_tpu.core.types import SimParams as JSim
    from evosoro_tpu.viz.sandbox import InteractiveSandbox as JSandbox

    s, phase, _ = sandbox_inputs()
    jb = j_build_body(s, j_palette(j_default_palette()), phase_offset=phase,
                      dtype=jnp.float64)
    sb = JSandbox(jb, JSim(init_cm_time=0.0), JEnv())
    # JAX's step takes its poke as `jnp.asarray` of a numpy buffer, which can
    # alias it, is dispatched asynchronously, and the buffer is zeroed when
    # the poke ends: a step still queued then runs without its force, and the
    # state after the poke varies from run to run (ROADMAP section C). Each
    # step here waits for its result, so the stored state has the whole poke.
    step = sb._step_jit
    sb._step_jit = lambda st, f: jax.block_until_ready(step(st, f))
    sb.step(5)
    sb.apply_force(*POKE)
    sb.step(60)
    return dict(pos=np.asarray(sb.state.pos), linmom=np.asarray(sb.state.linmom),
                quat=np.asarray(sb.state.quat), time=np.asarray(sb.state.time),
                com=sb.center_of_mass(), ke=np.asarray(sb.kinetic_energy()))


def test_sandbox_state_matches_jax():
    ref = stored(FIXTURE, "sandbox", *sandbox_inputs())
    sb = _sandbox(torch.float64).step(5)
    sb.apply_force(*POKE)
    sb.step(60)
    assert sb.state.pos.dtype == torch.float64
    np.testing.assert_allclose(sb.state.pos.numpy(), ref["pos"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sb.state.quat.numpy(), ref["quat"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sb.state.linmom.numpy(), ref["linmom"], rtol=1e-7,
                               atol=1e-7 * np.abs(ref["linmom"]).max())
    np.testing.assert_allclose(sb.time, ref["time"], rtol=1e-12)
    np.testing.assert_allclose(sb.center_of_mass(), ref["com"], rtol=1e-9)
    np.testing.assert_allclose(sb.kinetic_energy(), ref["ke"], rtol=1e-6)


def test_record_gif_and_repl_g_write_a_gif(tmp_path):
    sb = _sandbox()
    gif = tmp_path / "clip.gif"
    assert sb.record_gif(str(gif), steps=4, every=2) == str(gif)
    assert gif.stat().st_size > 1000 and sb.steps_done == 4
    out = io.StringIO()
    gif2 = tmp_path / "repl.gif"
    repl(sb.snapshot(), stdin=io.StringIO(f"g {gif2} 4 2\nq\n"), stdout=out)
    assert f"recorded {gif2}" in out.getvalue(), out.getvalue()
    assert gif2.stat().st_size > 1000 and sb.steps_done == 8
