"""The port's facet drag (`evosoro_tpu_torch.envs.drag`) held against the JAX
package's on the same inputs, made with numpy from a seed.

The gather tables must equal JAX's exactly (they are integers and +-1);
`mesh_drag_forces` runs in float64 on both sides and is held at rtol 1e-10
(the two sum the same terms; only the order of the scatter-add differs).
The three checks of tests/test_mesh_drag.py are repeated on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu.envs import aquatic as j_aquatic
from evosoro_tpu.envs import growth_env as j_growth_env
from evosoro_tpu.envs import limited_floor as j_limited_floor
from evosoro_tpu.envs import terrestrial as j_terrestrial
from evosoro_tpu.envs.drag import build_mesh_drag as j_build_mesh_drag
from evosoro_tpu.envs.drag import mesh_drag_forces as j_mesh_drag_forces
from evosoro_tpu_torch import convert, envs
from evosoro_tpu_torch.core import (
    EnvParams,
    SimParams,
    build_body,
    calc_max_dt,
    evosoro_default_palette,
    init_state,
    palette_from_list,
    rollout,
)
from evosoro_tpu_torch.core.step import _fluid_drag
from evosoro_tpu_torch.envs.drag import (
    MeshDragSystem,
    attach_mesh_drag,
    build_mesh_drag,
    build_mesh_drag_batch,
    mesh_drag_forces,
)

torch.set_num_threads(1)
F64 = dict(rtol=1e-10, atol=1e-18)


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _structure(n=4, seed=0):
    rng = np.random.default_rng(seed)
    structure = rng.integers(0, 5, size=(n, n, n)).astype(np.int32)
    structure[n // 2, n // 2, n // 2] = 3
    return structure, rng.uniform(-1, 1, size=(n, n, n))


def _body(n=4, seed=0):
    structure, phase = _structure(n, seed)
    return build_body(structure, palette_from_list(evosoro_default_palette()),
                      phase_offset=phase, dtype=torch.float64)


@pytest.mark.parametrize("pads", [(None, None), (400, 200)])
def test_build_mesh_drag_tables_equal_jax(pads):
    structure, _ = _structure(4, 1)
    ours = build_mesh_drag(structure, pad_tris=pads[0], pad_verts=pads[1])
    theirs = j_build_mesh_drag(structure, pad_tris=pads[0], pad_verts=pads[1])
    for name in ("vert_vox", "vert_sign", "vert_w", "tri_verts", "tri_owner", "tri_mask"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)), err_msg=name)
    assert ours.num_tris == theirs.num_tris
    with pytest.raises(ValueError):
        build_mesh_drag(structure, pad_tris=3)


def _deformed_state(jb, seed):
    """A JAX state with every voxel displaced, turned, rescaled and moving."""
    rng = np.random.default_rng(seed)
    st = j_init_state(jb, dtype=jnp.float64)
    shape = st.scale.shape
    quat = np.asarray(st.quat) + rng.normal(0, 0.05, size=shape + (4,))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return st.replace(
        pos=st.pos + rng.normal(0, 5e-4, size=shape + (3,)),
        quat=jnp.asarray(quat),
        scale=st.scale * rng.uniform(0.9, 1.1, size=shape),
        linmom=jnp.asarray(rng.normal(0, 1e-2, size=shape + (3,))) * jb.occ[..., None])


@pytest.mark.parametrize("strains", [False, True])
def test_mesh_drag_forces_match_jax_in_float64(strains):
    structure, phase = _structure(4, 2)
    jb = j_build_body(structure, j_palette(j_default_palette()), phase_offset=phase,
                      dtype=jnp.float64)
    jb = jb.replace(mesh_drag=j_build_mesh_drag(structure))
    st = _deformed_state(jb, 5)
    rng = np.random.default_rng(6)
    kw = {}
    if strains:
        kw = dict(strain_pos=jnp.asarray(rng.normal(0, 0.05, size=(3,) + structure.shape)),
                  strain_neg=jnp.asarray(rng.normal(0, 0.05, size=(3,) + structure.shape)),
                  nominal_size=jb.nominal_size)
    ref = np.asarray(j_mesh_drag_forces(st.pos, st.quat, st.scale, st.linmom,
                                        jb.mass_inv, jb.mesh_drag, 750.0, **kw))
    body = convert.body_from_numpy(_np(jb), dtype=torch.float64)
    assert isinstance(body.mesh_drag, MeshDragSystem)
    s = convert.state_from_numpy(_np(st), dtype=torch.float64)
    tkw = {k: (torch.as_tensor(np.asarray(v)) if k != "nominal_size" else float(v))
           for k, v in kw.items()}
    out = mesh_drag_forces(s.pos, s.quat, s.scale, s.linmom, body.mass_inv,
                           body.mesh_drag, 750.0, **tkw)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(out.numpy(), ref, **F64)
    # a leading batch dimension where JAX vmaps: one shared design ...
    b2 = lambda t: torch.stack([t, 0.5 * t])  # noqa: E731
    tkw2 = {k: (b2(v) if torch.is_tensor(v) else v) for k, v in tkw.items()}
    out2 = mesh_drag_forces(b2(s.pos), torch.stack([s.quat, s.quat]), b2(s.scale),
                            b2(s.linmom), body.mass_inv, body.mesh_drag,
                            torch.tensor([750.0, 375.0], dtype=torch.float64), **tkw2)
    np.testing.assert_allclose(out2[0].numpy(), ref, **F64)
    assert float(out2[1].abs().max()) > 0
    # ... and a table per robot, padded to common sizes
    other, _ = _structure(4, 3)
    batch = build_mesh_drag_batch(np.stack([structure, other]), dtype=torch.float64)
    minv = torch.stack([body.mass_inv, body.mass_inv])
    out3 = mesh_drag_forces(b2(s.pos), torch.stack([s.quat, s.quat]), b2(s.scale),
                            b2(s.linmom), minv, batch,
                            torch.tensor([750.0, 375.0], dtype=torch.float64), **tkw2)
    np.testing.assert_allclose(out3[0].numpy(), ref, **F64)


def test_mesh_drag_matches_voxel_drag_undeformed():
    """On an undeformed lattice with a uniform velocity and identity
    orientations the two models are analytically identical: each exposed
    face contributes -C scale^2 v_n^2 n to its owner."""
    body = attach_mesh_drag(_body())
    env = EnvParams(fluid_environment=True, aggregate_drag_coefficient=750.0)
    state = init_state(body)
    v = torch.tensor([0.13, -0.07, 0.4], dtype=torch.float64)
    state = state.replace(linmom=torch.where(body.occ[..., None],
                                             body.mass[..., None] * v, 0.0))
    vel = state.linmom * body.mass_inv[..., None]
    f_vox = _fluid_drag(state, body, env, vel)
    f_mesh = mesh_drag_forces(state.pos, state.quat, state.scale, state.linmom,
                              body.mass_inv, body.mesh_drag,
                              env.aggregate_drag_coefficient)
    assert float(f_vox.abs().max()) > 0
    np.testing.assert_allclose(f_mesh.numpy(), f_vox.numpy(), rtol=1e-9, atol=1e-12)


def test_mesh_drag_swimming_rollout_runs():
    body = attach_mesh_drag(_body(seed=2))
    sim = SimParams(init_cm_time=0.001)
    env = EnvParams(fluid_environment=True,
                    aggregate_drag_coefficient=0.5 * 1.5 * 1000.0,
                    gravity_enabled=True,  # off in a fluid: neutral buoyancy
                    floor_enabled=True)
    dt = calc_max_dt(body) * sim.dt_frac
    res = rollout(body, sim, env, num_steps=60, dt=dt)
    assert bool(torch.isfinite(res.final_state.pos).all())
    assert not bool(res.diverged)
    assert bool(torch.isfinite(res.final_state.ke_history[0]))
    # no gravity acted: the CoM's height moved by far less than a free fall
    # over the same time would (0.5 g t^2 = 7e-6 m)
    assert abs(float(res.final_cm[2] - res.ini_cm[2])) < 1e-6


def test_mesh_drag_opposes_motion():
    """Total drag power must be non-positive (forces oppose velocity)."""
    body = attach_mesh_drag(_body(seed=3))
    state = init_state(body)
    rng = np.random.default_rng(0)
    linmom = torch.as_tensor(rng.normal(size=tuple(state.linmom.shape))) \
        * body.mass[..., None]
    f = mesh_drag_forces(state.pos, state.quat, state.scale, linmom, body.mass_inv,
                         body.mesh_drag, 100.0)
    vel = linmom * body.mass_inv[..., None]
    assert float((f * vel).sum()) <= 1e-12
    assert float(f.abs().max()) > 0


@pytest.mark.parametrize("preset,kw", [("terrestrial", dict(frequency=2.0, sticky_floor=True)),
                                       ("growth_env", dict(growth_amplitude=0.6)),
                                       ("aquatic", dict(aggregate_drag_coefficient=300.0)),
                                       ("limited_floor", dict(floor_radius=0.02))])
def test_env_presets_equal_jax(preset, kw):
    ours = getattr(envs, preset)(**kw)
    theirs = dict(terrestrial=j_terrestrial, growth_env=j_growth_env,
                  aquatic=j_aquatic, limited_floor=j_limited_floor)[preset](**kw)
    assert convert.env_params_from_jax(theirs) == ours
