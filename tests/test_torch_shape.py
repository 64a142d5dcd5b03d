"""The port's shape descriptors (`core/shape.py`), its native library
(`native/`), mesh I/O (`io/mesh_io.py`) and marching tetrahedra
(`viz/marching.py`) held against the JAX package and their plain versions.

- The descriptors of one state, after a few eager steps in float64 from a
  seed, through the port and through JAX's `shape_descriptors` on the same
  positions, orientations and scales: rtol 1e-12 (both meshes are host
  numpy in float64, the two libraries built by g++ from one source).
- The four cases of tests/test_fitness_and_shape.py against the port's
  library and its numpy versions.
- The files the port writes are byte-equal to the JAX package's writers';
  STL and OBJ round trips; the smoothed surface equal to JAX's.
- A failed g++ build raises with g++'s message (no numpy fallback).
"""

import numpy as np
import pytest
import torch

from evosoro_tpu import native as j_native
from evosoro_tpu.core import shape as j_shape
from evosoro_tpu.core.materials import build_body as j_build_body
from evosoro_tpu.core.materials import palette_from_list as j_palette
from evosoro_tpu.core.rollout import init_state as j_init_state
from evosoro_tpu.core.types import evosoro_default_palette as j_default_palette
from evosoro_tpu.io import mesh_io as j_mesh_io
from evosoro_tpu.viz import marching as j_marching
from evosoro_tpu_torch import convert, native
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
from evosoro_tpu_torch.core import shape
from evosoro_tpu_torch.io import mesh_io
from evosoro_tpu_torch.ops import build
from evosoro_tpu_torch.viz import marching

torch.set_num_threads(1)


def _stepped(seed=2, n=4, steps=12):
    """(port state, port body, JAX body) of a random design after `steps`
    eager float64 steps from rest with actuation from the first step."""
    import jax

    rng = np.random.default_rng(seed)
    structure = rng.integers(0, 5, size=(n, n, n)).astype(np.int32)
    structure[n // 2, n // 2, 0] = 3
    jb = j_build_body(structure, j_palette(j_default_palette()),
                      phase_offset=rng.uniform(-1, 1, size=(n, n, n)), dtype=np.float64)
    body = convert.body_from_numpy(jax.tree_util.tree_map(np.asarray, jb), dtype=torch.float64)
    sim = SimParams(init_cm_time=0.0)
    dt = float(calc_max_dt(body)) * sim.dt_frac
    res = rollout(body, sim, EnvParams(temp_period=20 * dt), num_steps=steps, dt=dt)
    return res.final_state, body, jb


def test_shape_descriptors_match_jax_in_float64():
    state, body, jb = _stepped()
    js = j_init_state(jb).replace(pos=state.pos.numpy(), quat=state.quat.numpy(),
                                  scale=state.scale.numpy())
    ours, theirs = shape.shape_descriptors(state, body), j_shape.shape_descriptors(js, jb)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-12, atol=0, err_msg=k)
    # the body deformed: its volume is not the voxel count's
    assert abs(ours["robot_volume"] - float(body.occ.sum()) * 1e-6) > 1e-12
    verts, tris = shape.deformed_mesh(state, body)
    jverts, jtris = j_shape.deformed_mesh(js, jb)
    np.testing.assert_allclose(verts, jverts, rtol=1e-12, atol=1e-15)
    assert np.array_equal(tris, jtris)
    np.testing.assert_allclose(shape.robot_volume(state, body), ours["robot_volume"],
                               rtol=1e-15)
    assert shape.convex_hull_volume(state, body) == (ours["hull_volume"], ours["hull_area"])
    assert shape.shape_complexity(state, body) == ours["shape_complexity"]
    # the plain versions give the library's descriptors
    used = np.unique(tris.ravel())
    np.testing.assert_allclose(native._mesh_volume_np(verts, tris), ours["robot_volume"],
                               rtol=1e-12)
    np.testing.assert_allclose(native._shape_complexity_np(verts, tris),
                               ours["shape_complexity"], rtol=1e-12)
    np.testing.assert_allclose(native._convex_hull_volume_np(verts[used]),
                               (ours["hull_volume"], ours["hull_area"]), rtol=1e-9)


def test_a_batched_state_is_refused_by_name():
    s = np.full((2, 2, 2), 3, np.int32)
    body = build_body(s, palette_from_list(evosoro_default_palette()))
    batched = init_state(body).replace(pos=init_state(body).pos[None].expand(3, -1, -1, -1, -1))
    with pytest.raises(ValueError, match="one robot"):
        shape.shape_descriptors(batched, body)


# tests/test_fitness_and_shape.py:131-173, on the port's library and its
# numpy versions

def test_shape_descriptors_rest_state():
    s = np.zeros((3, 3, 3), np.int32)
    s[:, :, :2] = 3
    body = build_body(s, palette_from_list(evosoro_default_palette()))
    d = shape.shape_descriptors(init_state(body), body)
    assert np.isclose(d["robot_volume"], 18 * 0.01**3, rtol=1e-5)
    assert np.isclose(d["hull_volume"], 0.03 * 0.03 * 0.02, rtol=1e-5)
    assert 0.99 < d["convexity"] < 1.01
    # 3x3x2 slab: 9 top + 9 bottom + 4 sides x (3x2) = 42 faces, 2 tris each
    assert d["num_surface_triangles"] == 42 * 2


def test_native_hull_matches_scipy():
    pytest.importorskip("scipy")
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(150, 3))
    vol, area = native.convex_hull_volume(pts)
    hv, ha = native._convex_hull_volume_np(pts)
    assert np.isclose(vol, hv, rtol=1e-9)
    assert np.isclose(area, ha, rtol=1e-9)
    # the JAX package's build adds -march=native, which contracts FMAs
    np.testing.assert_allclose((vol, area), j_native.convex_hull_volume(pts), rtol=1e-12)


def test_native_codec_roundtrip():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 8, size=500).astype(np.uint8)
    text = native.encode_ascii_layer(ids)
    assert text == native._encode_ascii_layer_np(ids) == j_native.encode_ascii_layer(ids)
    assert np.array_equal(native.decode_ascii_layer(text), ids)
    assert np.array_equal(native._decode_ascii_layer_np(text), ids)
    with pytest.raises(ValueError, match="below '0'"):
        native.decode_ascii_layer("01/2")


def test_surface_triangles_native_matches_numpy():
    rng = np.random.default_rng(11)
    occ = rng.random((5, 4, 3)) > 0.4
    t_native = native.surface_triangles(occ)
    t_np = native._surface_triangles_np(occ.astype(np.uint8))
    # same multiset of triangles (order may differ)
    assert {tuple(r) for r in t_native.tolist()} == {tuple(r) for r in t_np.tolist()}
    assert np.array_equal(t_native, j_native.surface_triangles(occ))


def test_a_failed_build_raises_with_the_compilers_message(tmp_path):
    """No numpy fallback: a library that does not compile raises, and its
    library path is named by the source's hash, beside no source."""
    broken = tmp_path / "broken.cpp"
    broken.write_text("extern \"C\" int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        build.gxx_library("broken", [broken], native.GXX_FLAGS, directory=tmp_path / "out",
                          timeout=120)
    assert not list((tmp_path / "out").glob("*.so"))
    lib = build.gxx_library("evosoro_native", [native.SRC], native.GXX_FLAGS)
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libevosoro_native-")


# mesh I/O and marching tetrahedra (tests/test_marching.py's cases)

STRUCTURES = {
    "voxel": np.ones((1, 1, 1), np.int32),
    "block": np.ones((4, 3, 2), np.int32),
    "porous": (np.random.default_rng(0).random((5, 5, 5)) < 0.6).astype(np.int32),
    "empty": np.zeros((3, 3, 3), np.int32),
}


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_smooth_mesh_equals_jax(name):
    s = STRUCTURES[name]
    verts, faces = marching.smooth_structure_mesh(s, lattice_dim=0.01)
    jverts, jfaces = j_marching.smooth_structure_mesh(s, lattice_dim=0.01)
    assert np.array_equal(verts, jverts) and np.array_equal(faces, jfaces)
    assert np.array_equal(marching.occupancy_field(s), j_marching.occupancy_field(s))
    if name != "empty":
        assert marching.mesh_volume(verts, faces) > 0  # outward
        edges = {}
        for tri in faces:
            for a, b in ((0, 1), (1, 2), (2, 0)):
                e = tuple(sorted((tri[a], tri[b])))
                edges[e] = edges.get(e, 0) + 1
        assert set(edges.values()) == {2}  # watertight


def test_mesh_files_equal_jax_writers_and_round_trip(tmp_path):
    state, body, jb = _stepped(steps=6)
    verts, tris = shape.deformed_mesh(state, body)
    for fmt, kw in (("stl", dict(binary=True)), ("stl", dict(binary=False)), ("obj", {})):
        ours, theirs = tmp_path / f"ours.{fmt}", tmp_path / f"jax.{fmt}"
        if fmt == "stl":
            mesh_io.write_stl(str(ours), verts, tris, **kw)
            j_mesh_io.write_stl(str(theirs), verts, tris, **kw)
            back_v, back_t = mesh_io.read_stl(str(ours))
            jv, jt = j_mesh_io.read_stl(str(ours))
            assert np.array_equal(back_v, jv) and np.array_equal(back_t, jt)
            # welded back to the surface's corners and triangles (float32 in
            # a binary file)
            np.testing.assert_allclose(back_v[back_t], verts[tris],
                                       rtol=0, atol=1e-8 if kw["binary"] else 1e-9)
        else:
            mesh_io.write_obj(str(ours), verts, tris)
            j_mesh_io.write_obj(str(theirs), verts, tris)
        assert ours.read_bytes() == theirs.read_bytes()
    js = j_init_state(jb).replace(pos=state.pos.numpy(), quat=state.quat.numpy(),
                                  scale=state.scale.numpy())
    mesh_io.export_deformed_mesh(str(tmp_path / "d.obj"), state, body)
    j_mesh_io.export_deformed_mesh(str(tmp_path / "dj.obj"), js, jb)
    assert (tmp_path / "d.obj").read_bytes() == (tmp_path / "dj.obj").read_bytes()
    s = STRUCTURES["porous"]
    mesh_io.export_smooth_mesh(str(tmp_path / "s.stl"), s, 0.01)
    j_mesh_io.export_smooth_mesh(str(tmp_path / "sj.stl"), s, 0.01)
    assert (tmp_path / "s.stl").read_bytes() == (tmp_path / "sj.stl").read_bytes()
