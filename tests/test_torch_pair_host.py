"""The dense pair-contact pass (B2), checked without a card.

`ops/csrc/pair_contact.cuh` compiled for the host by g++ (the fixture of
tests/test_torch_b4_host.py: one thread a block, each warp-wide step as a
loop over its lanes) runs K2's two launches (`emu_pair`: the tile mask a
row group at a time, then blocks of 8 warps over 2 row groups, each group's
hot tiles split over 4 warps) and K1's step with the pass inside
(`emu_fwd_contact`). The routine's forces
are held against the port's plain version (`pair_contact_forces_plain`)
and against the JAX package's `_pair_contact_forces` (a plain jnp function,
run per robot) within K2_REL_TOL of the largest force: the two sum a row's
terms in other orders. Its tile counts (evaluated, culled by distance,
culled statically) equal the plain census (`pair_tile_census_plain`), which
computes the routine's tests in float32.

The bodies are 3^3-5^3 designs with the port's own collision tables
(`build_collision_system`), made from numpy seeds, their lattices shrunk
into contact where the case needs touching pairs. A negative cull margin
must drop touching pairs: the guard fails the tolerance by GUARD_RATIO.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_b4_host import host_lib  # noqa: F401
from test_torch_k1_host import _worst

from evosoro_tpu.ops.fused_rollout import _pair_contact_forces
from evosoro_tpu_torch import bench
from evosoro_tpu_torch.core import build_body, evosoro_default_palette, palette_from_list
from evosoro_tpu_torch.core.collision import build_collision_system
from evosoro_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(1)
K2_REL_TOL = 1e-4  # chip_smoke.py: K2 against its plain version
GUARD_RATIO = 20.0  # chip_smoke.py: a guard's error over the tolerance
HOST_TOL = 1e-4  # tests/test_torch_k1_host.py: K1 built by g++ against plain
L = 0.01
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def pair_lib(host_lib):  # noqa: F811
    host_lib.emu_pair.argtypes = [P, P, P, P, I, I, I, ctypes.c_float, P]
    host_lib.emu_fwd_contact.argtypes = [P, P, I, P, P] + [I] * 8 + [P, I, P, P, I]
    return host_lib


def _emu_pair(lib, pos, scale, a1, margin=fr.PAIR_CULL_MARGIN):
    """The host-built K2: forces and the launch's tile counts."""
    B, _, V = pos.shape
    out = torch.empty_like(pos)
    counts = torch.zeros(3, dtype=torch.int32)
    lib.emu_pair(pos.data_ptr(), scale.data_ptr(), a1.data_ptr(), out.data_ptr(), B, V,
                 int(a1.shape[0] == B and B > 1), margin, counts.data_ptr())
    return out, tuple(int(c) for c in counts)


def _jax_forces(pos, scale, a1):
    """JAX's `_pair_contact_forces` robot by robot, (B, 3, V)."""
    out = []
    for b in range(pos.shape[0]):
        p3 = [jnp.asarray(pos[b, c].numpy())[None] for c in range(3)]
        s = jnp.asarray(scale[b].numpy())[None]
        t = jnp.asarray(a1[b if a1.shape[0] > 1 else 0].numpy())
        f = _pair_contact_forces(p3, s, t, jnp.float32)
        out.append(np.concatenate([np.asarray(c) for c in f], 0))
    return torch.as_tensor(np.stack(out))


def _rel(got, ref):
    return float((got - ref).abs().max()) / float(ref.abs().max())


def _design(structure, seed):
    """Nominal positions (3, V), scales (V,) and the dense pair table (V, V)
    of a design on evosoro's palette."""
    rng = np.random.default_rng(seed)
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      lattice_dim=L, phase_offset=rng.uniform(0, 1, structure.shape))
    cs = build_collision_system(structure, body.e_mod.numpy(), L)
    pos = body.nom_pos.reshape(-1, 3).T.numpy().astype(np.float32)
    return pos, fr.pack_collision(cs, structure.shape)


def _shrunk(pos, occ, factor, rng):
    """pos (3, V) with the occupied voxels pulled toward their centre by
    `factor` and jittered, so surface voxels far apart on the lattice touch."""
    c = pos[:, occ].mean(1, keepdims=True)
    out = pos.copy()
    out[:, occ] = c + factor * (pos[:, occ] - c) + rng.normal(0, 5e-4, (3, int(occ.sum())))
    return out


def _batch(items):
    pos = torch.as_tensor(np.stack([p for p, _ in items]), dtype=torch.float32)
    a1 = torch.as_tensor(np.stack([t for _, t in items]), dtype=torch.float32)
    scale = torch.full(pos.shape[::2], L, dtype=torch.float32)
    return pos.contiguous(), scale, a1.contiguous()


def _check(lib, pos, scale, a1):
    """The host-built pass against both plain versions; returns its counts."""
    ref = fr.pair_contact_forces_plain(pos, scale, a1)
    assert float(ref.abs().max()) > 0, "no touching pair"
    got, counts = _emu_pair(lib, pos, scale, a1)
    assert _rel(got, ref) <= K2_REL_TOL
    assert _rel(got, _jax_forces(pos, scale, a1)) <= K2_REL_TOL
    assert counts == fr.pair_tile_census_plain(pos, scale, a1)
    G = fr.pair_groups(pos.shape[2])
    assert sum(counts) == pos.shape[0] * G * G
    return counts


def test_squeezed_5_cubed_body(pair_lib):
    """A full 5^3 body shrunk to half its size: every surface voxel touches
    others, four row groups, each split over four warps."""
    rng = np.random.default_rng(0)
    structure = rng.integers(1, 5, size=(5, 5, 5))
    pos, table = _design(structure, 0)
    occ = structure.reshape(-1) > 0
    counts = _check(pair_lib, *_batch([(_shrunk(pos, occ, 0.5, rng), table)]))
    assert counts[0] > 0


@pytest.mark.parametrize("n", [3, 4, 5])
def test_evaluator_batch_with_a_table_per_robot(pair_lib, n):
    """The evaluator's layout: a random design, its body and its pair table
    per robot (empty cells among them), each shrunk into contact."""
    rng = np.random.default_rng(n)
    items = []
    for b in range(4):
        structure = rng.integers(0, 5, size=(n, n, n))
        structure[0, 0, 0] = 1
        pos, table = _design(structure, b)
        items.append((_shrunk(pos, structure.reshape(-1) > 0, 0.55, rng), table))
    _check(pair_lib, *_batch(items))


def test_table_with_all_zero_rows(pair_lib):
    """Rows zeroed while their columns stay: a voxel with no row of its own
    is still active (and boxed) through its column, as the cull needs."""
    rng = np.random.default_rng(7)
    structure = np.ones((5, 5, 5), dtype=np.int64)
    pos, table = _design(structure, 7)
    table = table.copy()
    zero = rng.choice(125, size=40, replace=False)
    table[zero] = 0.0
    assert (table[:, zero] != 0).any()
    pos = _shrunk(pos, np.ones(125, bool), 0.5, rng)
    _check(pair_lib, *_batch([(pos, table)]))


def _two_slabs(shift, squeeze):
    """A 5^3 grid with material in x = 0, 1 and x = 4 only: row group 2
    (x = 2, 3) is all empty cells (its tiles culled statically) and groups
    0, 1 lie 3 cells from group 3 (culled by distance). `shift` moves the
    x = 4 slab toward the others by that many cells; `squeeze` pulls each
    slab's voxels toward its own centre in y and z."""
    rng = np.random.default_rng(11)
    structure = np.zeros((5, 5, 5), dtype=np.int64)
    structure[:2] = rng.integers(1, 5, size=(2, 5, 5))
    structure[4] = rng.integers(1, 5, size=(5, 5))
    pos, table = _design(structure, 11)
    x = np.arange(125) // 25
    pos = pos.copy()
    pos[0, x == 4] -= shift * L
    for slab in (x < 2, x == 4):
        c = pos[1:, slab].mean(1, keepdims=True)
        pos[1:, slab] = c + squeeze * (pos[1:, slab] - c)
    return _batch([(pos + rng.normal(0, 2e-4, pos.shape).astype(np.float32), table)])


def test_static_and_distance_culls(pair_lib):
    """Both culls fire, and the pass still gives the plain forces."""
    evaluated, by_distance, static = _check(pair_lib, *_two_slabs(0.0, 0.3))
    assert evaluated > 0 and by_distance > 0 and static > 0


def test_cull_guard(pair_lib):
    """The x = 4 slab pushed to 1.3 cells from x = 1: the only contacts are
    across the gap. A margin of -0.5 halves the cull's radius and drops
    those tiles, and the forces miss the tolerance by GUARD_RATIO or more;
    the routine's own margin keeps them."""
    pos, scale, a1 = _two_slabs(1.7, 1.0)
    ref = fr.pair_contact_forces_plain(pos, scale, a1)
    got, counts = _emu_pair(pair_lib, pos, scale, a1)
    assert _rel(got, ref) <= K2_REL_TOL
    dropped, c_bad = _emu_pair(pair_lib, pos, scale, a1, margin=-0.5)
    assert c_bad[0] < counts[0]
    assert c_bad == fr.pair_tile_census_plain(pos, scale, a1, margin=-0.5)
    assert _rel(dropped, ref) >= GUARD_RATIO * K2_REL_TOL


def _host_contact(lib, args, kw, steps):
    state, body, stats, table = args
    B, _, V = state.shape
    X, Y, Z = kw["grid_shape"]
    st, sa = state.clone(), stats.clone()
    ctrl = torch.zeros((B, 1, V))
    params = fr._k1_params(kw["scalars"], fr.DEFAULT_PRECISION)
    fparams = fr._feat_params(kw["scalars"], kw["flags"])
    lib.emu_fwd_contact(st.data_ptr(), body.data_ptr(), int(body.shape[0] == B and B > 1),
                        sa.data_ptr(), ctrl.data_ptr(), 0, steps, 0, B, X, Y, Z, steps,
                        params.ctypes.data, fr._flag_bits(kw["flags"]), fparams.ctypes.data,
                        table.data_ptr(), int(table.shape[0] == B and B > 1))
    return st, sa


def test_k1_step_with_contact_matches_plain(pair_lib):
    """K1's land step built by g++ with the pass inside, 10 steps of the
    bench design at 5^3 shrunk into contact, against `fused_rollout_plain`
    at the group tolerance of tests/test_torch_k1_host.py; the same launch
    with the table zeroed lands far outside it."""
    args, kw, _ = bench.packed_workload(2, n=5, collision=True, device="cpu")
    state, body, stats, table = args
    occ = body[0, fr._B_OCC] > 0.5
    state = state.clone()
    for b, f in enumerate((0.6, 0.7)):
        p = state[b, fr._POS:fr._POS + 3]
        c = p[:, occ].mean(1, keepdim=True)
        state[b, fr._POS:fr._POS + 3] = torch.where(occ, c + f * (p - c), p)
    args = (state, body, stats, table)
    out_h, st_h = _host_contact(pair_lib, args, kw, 10)
    out_p, st_p = fr.fused_call(*args, num_steps=10, **kw)
    assert _worst(out_h, out_p) <= HOST_TOL
    torch.testing.assert_close(st_h[:, :fr._S_STOP], st_p[:, :fr._S_STOP],
                               rtol=2e-5, atol=1e-9)
    out_0, _ = _host_contact(pair_lib, (state, body, stats, torch.zeros_like(table)), kw, 10)
    assert _worst(out_0, out_p) > 100 * HOST_TOL
