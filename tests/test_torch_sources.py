"""The port's environmental sources (`evosoro_tpu_torch.envs.sources`)
held against the JAX package's `evosoro_tpu.envs.sources` on the same
inputs, made with numpy from a seed, and tests/test_env_sources.py's checks
of the tracking (its `.vxa` round trip waits for the reader, which is not
ported yet). The rollouts run the port's eager path in float64; its source
tracking is held against JAX's rollout, and the fused path's against the
JAX kernel, by tests/test_torch_features.py (one compile of each).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.core.quaternion import quat_from_rotation_vector as j_quat_from_rv
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.envs import sources as j_sources
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.core import (
    EnvParams,
    SimParams,
    build_body,
    calc_max_dt,
    evosoro_default_palette,
    init_state,
    num_steps_for,
    palette_from_list,
    rollout,
)
from evosoro_tpu_torch.core.quaternion import quat_from_rotation_vector
from evosoro_tpu_torch.envs import sources
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)
jfr = importlib.import_module("evosoro_tpu.ops.fused_rollout")

ENTRIES = [
    dict(pos=(0.1, 0.01, 0.01), amp=(0.02, 0.0, 0.01), freq=(3.0, 0.0, 7.0), enabled=True),
    dict(pos=(0.01, 0.2, 0.01), enabled=True, type=1),
    dict(pos=(-0.3, 0.0, 0.05), amp=(0.0, 0.1, 0.0), freq=(0.0, 2.0, 0.0)),
]


def _body():
    structure = np.ones((2, 2, 2), dtype=np.int32)
    return build_body(structure, palette_from_list(evosoro_default_palette()),
                      lattice_dim=0.01, dtype=torch.float64)


def test_make_sources_and_positions_equal_jax():
    """The parameters, the truncated pi of Vec3D.h, and the oscillating
    positions at scalar and per-robot times."""
    assert sources.REF_PI_VEC3D == j_sources.REF_PI_VEC3D
    assert sources.UPDATE_SOURCES_HIST_EVERY == j_sources.UPDATE_SOURCES_HIST_EVERY == 50
    assert sources.make_sources([]) is None and j_sources.make_sources([]) is None
    got, ref = sources.make_sources(ENTRIES), j_sources.make_sources(ENTRIES)
    assert got.num_sources == ref.num_sources == 3
    for f in ("base_pos", "amp", "freq", "enabled", "source_type"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    for tau in (0.0, 0.0375, 0.125, 0.61):
        np.testing.assert_allclose(sources.source_positions(got, tau).numpy(),
                                   np.asarray(j_sources.source_positions(ref, tau)),
                                   rtol=1e-15, atol=1e-17)
    taus = np.array([0.0, 0.02, 0.3])
    batch = sources.source_positions(got, torch.as_tensor(taus)).numpy()
    assert batch.shape == (3, 3, 3)
    for i, tau in enumerate(taus):
        np.testing.assert_allclose(batch[i], np.asarray(j_sources.source_positions(ref, tau)),
                                   rtol=1e-15, atol=1e-17)
    # a quarter period of a 2 Hz swing (sin(pi/2) = 1, up to the truncated pi)
    one = sources.make_sources([dict(pos=(0, 0, 0), amp=(0.1, 0, 0), freq=(2.0, 0, 0),
                                     enabled=True)])
    assert abs(float(sources.source_positions(one, 0.125)[0, 0]) - 0.1) < 1e-6


def test_min_distances_equal_jax():
    """Nearest occupied voxel of moved, partly empty bodies, in lattice
    units, one robot and a batch of them."""
    rng = np.random.default_rng(4)
    structure = rng.integers(0, 3, size=(3, 4, 2)).astype(np.int32)
    structure[0, 0, 0] = 1
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      dtype=torch.float64)
    pos = body.nom_pos.numpy() + rng.normal(0, 0.002, size=(5,) + body.nom_pos.shape)
    src = sources.make_sources(ENTRIES)
    spos = sources.source_positions(src, torch.as_tensor(rng.uniform(0, 1, size=5)))
    state = init_state(body).replace(pos=torch.as_tensor(pos))
    got = sources.min_distances(spos, state, body).numpy()
    jbody = type("B", (), dict(occ=jnp.asarray(structure > 0), nominal_size=0.01))
    for i in range(5):
        jstate = type("S", (), dict(pos=jnp.asarray(pos[i])))
        ref = j_sources.min_distances(jnp.asarray(spos[i].numpy()), jstate, jbody)
        np.testing.assert_allclose(got[i], np.asarray(ref), rtol=1e-14)


def test_pointing_error_equals_jax():
    rng = np.random.default_rng(9)
    for _ in range(4):
        rv = rng.normal(0, 1, size=3)
        tip, vec, target = (rng.normal(0, 1, size=3) for _ in range(3))
        ref = j_sources.pointing_error_deg(jnp.asarray(tip), j_quat_from_rv(jnp.asarray(rv)),
                                           jnp.asarray(vec), jnp.asarray(target))
        got = sources.pointing_error_deg(torch.as_tensor(tip),
                                         quat_from_rotation_vector(torch.as_tensor(rv)),
                                         vec, target)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-10, atol=1e-10)


def test_min_and_avg_distance_tracked():
    """tests/test_env_sources.py's check on the port's eager rollout: the
    nearest voxel of a resting 2x2x2 block to two fixed sources, and the
    mean of the 50-step history samples beside the final minimum."""
    body = _body()
    src = sources.make_sources([dict(pos=(0.1, 0.01, 0.01), enabled=True),
                                dict(pos=(0.01, 0.2, 0.01), enabled=True)])
    sim = SimParams(stop_condition_value=0.02, init_cm_time=0.0)
    env = EnvParams(sources=src, temp_enabled=False)
    dt = float(calc_max_dt(body)) * float(sim.dt_frac)
    res = rollout(body, sim, env, num_steps_for(body, sim, dt=dt), dt=dt)
    md = res.source_min_dist.numpy()
    assert md.shape == (2,)
    d0 = np.linalg.norm([0.1 - 0.015, 0.01 - 0.005, 0.01 - 0.005]) / 0.01
    assert abs(md[0] - d0) < 0.2  # the body settles a little
    avg = res.source_avg_min_dist.numpy()
    assert (avg > 0).all()
    np.testing.assert_allclose(avg, md, rtol=0.05)  # a barely moving body


def test_sources_cross_into_the_port_and_the_kernel_scalars():
    """`convert.env_params_from_jax` carries the sources; `kernel_scalars`
    keeps the enabled ones as the JAX package's do (K1 takes up to 3)."""
    ref = JEnv(sources=j_sources.make_sources(ENTRIES))
    env = convert.env_params_from_jax(ref)
    np.testing.assert_array_equal(env.sources.freq.numpy(), np.asarray(ref.sources.freq))
    got = fr.kernel_scalars(0.01, SimParams(), env)["sources"]
    want = jfr.kernel_scalars(0.01, JSim(), ref)["sources"]
    assert got == want and len(got) == 2
    assert fr.kernel_scalars(0.01, SimParams(), EnvParams())["sources"] == ()
    with pytest.raises(NotImplementedError, match="sources"):
        fr.check_envelope({}, {"sources": want * 2})
