"""The port's trajectory recording and renderer (`evosoro_tpu_torch.viz`)
held against the JAX package's on the same inputs.

`record_trajectory` runs K1 inside its envelope (one launch a frame, the
packed state and stats row carried over) and the eager step outside it. In
float64 on the CPU both routes are held against JAX's jitted scan at the
chain-of-trust tolerances (ROADMAP, top: pos rtol 2e-5, quat rtol 2e-5 /
atol 1e-7, scale rtol 1e-6, time rtol 1e-6), channel by channel: the
actuation starts at the first step, and in float64 the quaternion snap
(ROADMAP section C) does not flip on these short runs. The chained launches
are held bit for bit against one launch at every frame boundary, in float32
and in float64. JAX's sides are jitted scans, several seconds each to
compile, so they are read from `tests/fixtures/viz_analysis_jax.npz`
after checking the digest of the numpy inputs both packages build their
bodies from (`make_viz_analysis_jax.py` rewrites it).
"""

import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.types import EnvParams as JEnv
from evosoro_tpu.core.types import SimParams as JSim
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu_torch.core import (
    EnvParams,
    SimParams,
    build_body,
    calc_max_dt,
    init_state,
    palette_from_list,
)
from evosoro_tpu_torch.core.types import evosoro_default_palette
from evosoro_tpu_torch.ops import fused_rollout as fr
from evosoro_tpu_torch.viz import record_trajectory, render_state, save_animation
from evosoro_tpu_torch.viz import render, trajectory
from jax_outputs import stored

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "viz_analysis_jax.npz")
TOL = dict(pos=(2e-5, 1e-9), quat=(2e-5, 1e-7), scale=(1e-6, 0.0), time=(1e-6, 0.0))
# case -> (steps, every, env, knots)
TRAJ_CASES = {
    "k1": (23, 5, dict(), 0),
    "k1_controls": (23, 5, dict(), 3),
    "eager_limited_floor": (23, 5, dict(floor_limited=True, floor_radius=0.012), 0),
    # an external force is a BC channel of K1's material instance: K1 runs it
    "k1_external_force": (23, 5, dict(), 0),
}


def _structure(n=4):
    rng = np.random.default_rng(0)
    structure = rng.integers(0, 5, size=(n, n, n)).astype(np.int32)
    structure[n // 2, n // 2, 0] = 3
    return structure, rng.uniform(-1, 1, size=(n, n, n))


def _port_body(structure, phase, dtype=torch.float64, extf=None):
    return build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=phase, external_force=extf, dtype=dtype)


def _jax_body(structure, phase, extf=None):
    return j_build_body(structure, j_palette(j_default_palette()), phase_offset=phase,
                        external_force=extf, dtype=jnp.float64)


def _external_force(case, shape):
    """50 N along +x on the top layer (~1 kg voxels) in the external-force
    case."""
    if case != "k1_external_force":
        return None
    extf = np.zeros(shape + (3,))
    extf[:, :, -1, 0] = 50.0
    return extf


def traj_case(case):
    """(structure, phase, dt, steps, every, sim kwargs, env kwargs,
    controls, external force); dt is the port's stability step of the
    float64 body x 0.9."""
    steps, every, env_kw, knots = TRAJ_CASES[case]
    structure, phase = _structure()
    dt = float(calc_max_dt(_port_body(structure, phase))) * 0.9
    ctrl = None
    if knots:
        ctrl = np.random.default_rng(1).uniform(-0.05, 0.05, size=(knots,) + structure.shape)
    return (structure, phase, dt, steps, every, dict(init_cm_time=0.0), env_kw, ctrl,
            _external_force(case, structure.shape))


def traj_inputs(case):
    """What a case's stored frames were computed on, for the digest."""
    structure, phase, dt, steps, every, sim_kw, env_kw, ctrl, extf = traj_case(case)
    return (structure, phase, dt, JSim(**sim_kw), JEnv(**env_kw),
            0.0 if ctrl is None else ctrl, 0.0 if extf is None else extf,
            np.asarray([steps, every]))


def traj_jax(case):
    """JAX's frames of a case (for the fixture)."""
    from evosoro_tpu.viz import record_trajectory as j_record

    structure, phase, dt, steps, every, sim_kw, env_kw, ctrl, extf = traj_case(case)
    tr = j_record(_jax_body(structure, phase, extf), JSim(**sim_kw), JEnv(**env_kw),
                  num_steps=steps, dt=dt, every=every,
                  control_sequence=None if ctrl is None else jnp.asarray(ctrl))
    out = {k: np.asarray(getattr(tr, k)) for k in ("pos", "quat", "scale", "time")}
    out.update({"final_" + k: np.asarray(getattr(tr.final_state, k))
                for k in ("pos", "quat", "scale", "time")})
    return out


def _within(got, want, name, rtol, atol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("case", list(TRAJ_CASES))
def test_trajectory_matches_jax(case):
    structure, phase, dt, steps, every, sim_kw, env_kw, ctrl, extf = traj_case(case)
    ref = stored(FIXTURE, "traj_" + case, *traj_inputs(case))
    body = _port_body(structure, phase, extf=extf)
    tr = record_trajectory(body, SimParams(**sim_kw), EnvParams(**env_kw), num_steps=steps,
                           dt=dt, every=every,
                           control_sequence=None if ctrl is None else torch.as_tensor(ctrl))
    reason = trajectory.eager_reason(body, SimParams(**sim_kw), EnvParams(**env_kw),
                                     init_state(body))
    assert (reason is not None) == case.startswith("eager"), reason
    assert tr.pos.shape[0] == steps // every and tr.pos.dtype == torch.float64
    for k, (rtol, atol) in TOL.items():
        _within(getattr(tr, k).numpy(), ref[k], k, rtol, atol)
        _within(getattr(tr.final_state, k).numpy(), ref["final_" + k], "final " + k,
                rtol, atol)
    if case in ("eager_limited_floor", "k1_external_force"):  # it moved the voxels
        free = stored(FIXTURE, "traj_k1", *traj_inputs("k1"))
        assert np.abs(free["final_pos"] - ref["final_pos"]).max() > 1e3 * TOL["pos"][1]


def _chain(body, dt, steps, ctrl, state):
    return trajectory.K1Chain(body, SimParams(init_cm_time=0.0), EnvParams(), state, dt,
                              steps, control_sequence=ctrl)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chained_launches_equal_one_launch(dtype):
    """A launch a frame, each carrying the last one's packed state and
    stats row (time, and with it the actuation phase; the knot clock through
    seg_base), gives at every frame boundary the bits of one launch of as
    many steps."""
    structure, phase = _structure()
    body = _port_body(structure, phase, dtype)
    dt = calc_max_dt(body) * 0.9
    steps, every = 12, 4
    ctrl = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.05, 0.05, size=(3,) + structure.shape)).to(dtype)
    state = init_state(body)
    chained = _chain(body, dt, steps, ctrl, state)
    for f in range(1, steps // every + 1):
        chained.advance(every)
        one = _chain(body, dt, steps, ctrl, state).advance(f * every)
        assert torch.equal(chained.state, one.state), f
        assert torch.equal(chained.stats, one.stats), f
    assert float(chained.pose()[3]) > 0.0


def test_k1_launches_per_route():
    """K1 launches once a frame and once for the remainder; the eager route
    launches nothing."""
    structure, phase = _structure()
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=phase)
    calls = []

    def counted(*a, **kw):
        calls.append(kw["num_steps"])
        return real(*a, **kw)

    real = fr.fused_call
    with mock.patch.object(fr, "fused_call", counted):
        tr = record_trajectory(body, SimParams(), EnvParams(), num_steps=7, every=3)
        assert calls == [3, 3, 1] and tr.pos.shape[0] == 2
        calls.clear()
        limited = EnvParams(floor_limited=True, floor_radius=0.02)
        record_trajectory(body, SimParams(), limited, num_steps=7, every=3)
        assert calls == []
    assert "limited floor" in trajectory.eager_reason(body, SimParams(), limited,
                                                      init_state(body))


def test_record_trajectory_shapes():
    """tests/test_viz.py:23-35 on the port (float32, the K1 route)."""
    structure, phase = _structure()
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=phase)
    sim = SimParams(init_cm_time=0.001)
    dt = calc_max_dt(body) * sim.dt_frac
    traj = record_trajectory(body, sim, EnvParams(), num_steps=47, dt=dt, every=10)
    assert traj.pos.shape[0] == 4  # frames at steps 0, 10, 20, 30
    assert traj.quat.shape[-1] == 4
    np.testing.assert_allclose(float(traj.final_state.time), 47 * float(dt), rtol=1e-6)
    assert bool(torch.isfinite(traj.pos).all())


def surface_case():
    """A design and a deformed pose of it: the rest pose moved and turned
    by a seeded noise."""
    structure, phase = _structure()
    rng = np.random.default_rng(2)
    nom = _port_body(structure, phase).nom_pos.numpy()
    pos = nom + rng.normal(size=structure.shape + (3,)) * 1e-3
    quat = np.concatenate([np.ones(structure.shape + (1,)),
                           rng.normal(size=structure.shape + (3,)) * 0.05], -1)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    scale = 0.01 * (1.0 + rng.uniform(-0.1, 0.1, size=structure.shape))
    return structure, phase, pos, quat, scale


def surface_jax():
    """JAX's vertices, triangles, owners and face colours (as its
    render_state computes them)."""
    from evosoro_tpu.envs.drag import build_mesh_drag as j_build_mesh_drag
    from evosoro_tpu.viz.render import _deformed_vertices as j_vertices
    from evosoro_tpu.viz.render import material_colors as j_colors

    structure, phase, pos, quat, scale = surface_case()
    jb = _jax_body(structure, phase)
    sys = j_build_mesh_drag(np.asarray(jb.mat))
    mask = np.asarray(sys.tri_mask)
    owners = np.asarray(sys.tri_owner)[mask]
    cmap = j_colors(j_default_palette())
    mats = np.asarray(jb.mat).reshape(-1)[owners]
    return dict(verts=j_vertices(pos, quat, scale, sys),
                tri=np.asarray(sys.tri_verts)[mask], owners=owners,
                colors=np.array([cmap.get(int(m), (0.5, 0.5, 0.5, 1.0)) for m in mats]))


def test_surface_matches_jax():
    structure, phase, pos, quat, scale = surface_case()
    ref = stored(FIXTURE, "surface", structure, phase, pos, quat, scale)
    verts, tri, owners, colors = render.surface(
        _port_body(structure, phase),
        (torch.as_tensor(pos), torch.as_tensor(quat), torch.as_tensor(scale)))
    np.testing.assert_allclose(verts, ref["verts"], rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(tri, ref["tri"])
    np.testing.assert_array_equal(owners, ref["owners"])
    np.testing.assert_array_equal(colors, ref["colors"])


def test_render_and_animate(tmp_path):
    """tests/test_viz.py:38-51 on the port: a PNG and a GIF of over 1000
    bytes each."""
    structure, phase = _structure()
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=phase)
    sim = SimParams(init_cm_time=0.001)
    dt = calc_max_dt(body) * sim.dt_frac
    traj = record_trajectory(body, sim, EnvParams(), num_steps=30, dt=dt, every=10)
    png = os.path.join(tmp_path, "state.png")
    render_state(body, traj.final_state, path=png)
    assert os.path.getsize(png) > 1000
    gif = os.path.join(tmp_path, "clip.gif")
    save_animation(body, traj, gif, fps=5)
    assert os.path.getsize(gif) > 1000
