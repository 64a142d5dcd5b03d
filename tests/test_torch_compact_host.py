"""The surface-compacted contact pass (B5), checked without a card.

`ops/csrc/pair_contact.cuh` compiled for the host by g++ (the fixture of
tests/test_torch_b4_host.py: one thread a block, each warp-wide step as a
loop over its lanes) runs the pair pass as K1's step runs it
(`emu_pair_alone`: the tile mask, the staging and the row owners, a warp
for each row group) over the S surface voxels of the compact table (the
index row's gather and scatter) and over the V voxels of the dense table.
The collision system orders the surface in flat x-major order, so the two
meet each row's nonzero terms in the same order: their forces are equal,
value for value. The compact pass is held against the port's plain version
(`pair_contact_forces_compact_plain`) and the JAX package's
`_pair_contact_forces_compact` (a plain jnp function, run per robot on
JAX's own packing) within K2_REL_TOL of the largest force, and its tile
counts (evaluated, culled by distance, culled statically) equal the plain
census over the index row (`pair_tile_census_plain(..., idx=)`). A negative
cull margin must drop touching pairs: the guard fails the tolerance by
GUARD_RATIO. K1's material instance built by g++ steps the same state with
either table to the same bits (`emu_fwd_vol`).

The bodies are 3^3-5^3 designs made from numpy seeds with the port's and
JAX's collision tables, their lattices shrunk into contact: a porous
design, the solid 5^3 body (S = 98) and a porous one of S = 97, one past a
multiple of 32 (a last group of one entry).
"""

import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_b4_host import host_lib  # noqa: F401
from test_torch_k1_host import _host_any, _squeezed, _stirred

from evosoro_tpu.core.collision import build_collision_system as j_build_cs
from evosoro_tpu_torch import bench
from evosoro_tpu_torch.core import build_body, evosoro_default_palette, palette_from_list
from evosoro_tpu_torch.core.collision import build_collision_system
from evosoro_tpu_torch.ops import fused_rollout as fr

jfr = importlib.import_module("evosoro_tpu.ops.fused_rollout")
torch.set_num_threads(1)
K2_REL_TOL = 1e-4  # chip_smoke.py: the pair pass against its plain version
GUARD_RATIO = 20.0  # chip_smoke.py: a guard's error over the tolerance
L = 0.01
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def pair_lib(host_lib):  # noqa: F811
    host_lib.emu_pair_alone.argtypes = [P, P, P, P, I, I, I, I, ctypes.c_float, P]
    return host_lib


def _alone(lib, pos, scale, table, margin=fr.PAIR_CULL_MARGIN):
    """K1's pass alone, built by g++, on a compact (B or 1, S + 1, S) or a
    dense (B or 1, V, V) table: forces and the tile counts."""
    B, _, V = pos.shape
    compact = table.shape[1] != table.shape[2]
    out = torch.empty_like(pos)
    counts = torch.zeros(3, dtype=torch.int32)
    lib.emu_pair_alone(pos.data_ptr(), scale.data_ptr(), table.data_ptr(), out.data_ptr(), B,
                       V, table.shape[2] if compact else 0, int(table.shape[0] == B and B > 1),
                       margin, counts.data_ptr())
    return out, tuple(int(c) for c in counts)


def _design(structure, seed):
    """Nominal positions (3, V), the dense (V, V) and the compact (S + 1, S)
    tables, and JAX's compact packing (Vp + Sp, Sp) of a design on evosoro's
    palette."""
    rng = np.random.default_rng(seed)
    body = build_body(structure, palette_from_list(evosoro_default_palette()),
                      lattice_dim=L, phase_offset=rng.uniform(0, 1, structure.shape))
    e = body.e_mod.numpy()
    cs = build_collision_system(structure, e, L)
    V = structure.size
    Vp = -(-V // 128) * 128
    jtab = np.asarray(jfr.pack_collision_compact(j_build_cs(structure, e, L), Vp,
                                                 structure.shape))
    pos = body.nom_pos.reshape(-1, 3).T.numpy().astype(np.float32)
    return (pos, fr.pack_collision(cs, structure.shape),
            fr.pack_collision_compact(cs, structure.shape), jtab)


def _shrunk(pos, occ, factor, rng):
    """pos (3, V) with the occupied voxels pulled toward their centre by
    `factor` and jittered, so surface voxels far apart on the lattice touch."""
    c = pos[:, occ].mean(1, keepdims=True)
    out = pos.copy()
    out[:, occ] = c + factor * (pos[:, occ] - c) + rng.normal(0, 5e-4, (3, int(occ.sum())))
    return out


def _jax_forces(pos, scale, jtab):
    """JAX's `_pair_contact_forces_compact` robot by robot, (B, 3, V)."""
    B, _, V = pos.shape
    Vp = jtab.shape[0] - jtab.shape[1]
    out = []
    for b in range(B):
        p = np.zeros((3, Vp), np.float32)
        p[:, :V] = pos[b].numpy()
        s = np.zeros((1, Vp), np.float32)
        s[0, :V] = scale[b].numpy()
        f = jfr._pair_contact_forces_compact(tuple(jnp.asarray(p[c:c + 1]) for c in range(3)),
                                             jnp.asarray(s), jnp.asarray(jtab), Vp, jnp.float32)
        out.append(np.concatenate([np.asarray(c) for c in f], 0)[:, :V])
    return torch.as_tensor(np.stack(out))


def _rel(got, ref):
    return float((got - ref).abs().max()) / float(ref.abs().max())


def _structure(case):
    if case == "solid":
        return np.ones((5, 5, 5), dtype=np.int64), 0
    seed = {"porous": 4, "past_32": 33}[case]
    rng = np.random.default_rng(seed)
    structure = rng.integers(0, 5, size=(5, 5, 5))
    structure[0, 0, 0] = 1
    return structure, seed


def _inputs(case, batch=2):
    """A design's robots shrunk into contact (each by its own factor): pos
    (B, 3, V), scale (B, V), the dense (1, V, V) and compact (1, S + 1, S)
    tables, JAX's packing."""
    structure, seed = _structure(case)
    pos, dense, compact, jtab = _design(structure, seed)
    rng = np.random.default_rng(seed + 100)
    occ = structure.reshape(-1) > 0
    p = np.stack([_shrunk(pos, occ, f, rng) for f in (0.5, 0.6, 0.7)[:batch]])
    scale = rng.uniform(0.009, 0.011, size=(batch, structure.size))
    f32 = dict(dtype=torch.float32)
    return (torch.as_tensor(p, **f32).contiguous(), torch.as_tensor(scale, **f32).contiguous(),
            torch.as_tensor(dense[None], **f32), torch.as_tensor(compact[None], **f32), jtab)


@pytest.mark.parametrize("case,surface", [("porous", None), ("solid", 98), ("past_32", 97)])
def test_compact_pass_equals_the_dense_pass(pair_lib, case, surface):
    """The compact pass equals the dense pass (torch.equal) after the
    scatter, agrees with both plain versions, and counts the census's
    tiles over its S entries."""
    pos, scale, dense, compact, jtab = _inputs(case)
    S = compact.shape[2]
    assert surface is None or S == surface
    assert bool((compact[0, 0, 1:] > compact[0, 0, :-1]).all())  # ascending flat order
    f_c, counts = _alone(pair_lib, pos, scale, compact)
    f_d, _ = _alone(pair_lib, pos, scale, dense)
    assert torch.equal(f_c, f_d)
    ref = fr.pair_contact_forces_compact_plain(pos, scale, compact)
    assert float(ref.abs().max()) > 0, "no touching pair"
    assert _rel(f_c, ref) <= K2_REL_TOL
    assert _rel(f_c, _jax_forces(pos, scale, jtab)) <= K2_REL_TOL
    assert counts == fr.pair_tile_census_plain(pos, scale, compact[:, 1:], idx=compact[:, 0])
    G = fr.pair_groups(S)
    assert sum(counts) == pos.shape[0] * G * G and counts[0] > 0
    # voxels off the surface feel -0, as the dense pass's zero rows give them
    off = torch.ones(pos.shape[2], dtype=torch.bool)
    off[compact[0, 0].long()] = False
    assert bool((f_c[:, :, off] == 0).all()) and bool(torch.signbit(f_c[:, :, off]).all())
    # a table for each robot reads each robot's own
    per_robot = compact.expand(pos.shape[0], -1, -1).contiguous()
    assert torch.equal(_alone(pair_lib, pos, scale, per_robot)[0], f_c)


def test_compact_pass_culls_and_its_guard(pair_lib):
    """A 10 x 4 x 4 grid with three slabs of two layers, x = 0-1, 4-5 and
    8-9, a 32-entry group of the surface each; the last pushed to 1.3 cells
    from the middle one, so the only contacts lie across that gap and the
    first slab's tiles with the others are culled by distance. The pass
    keeps the plain forces and the dense pass's; a margin of -0.5 halves
    the cull's radius, drops the touching tiles, and misses the tolerance
    by GUARD_RATIO or more."""
    rng = np.random.default_rng(11)
    structure = np.zeros((10, 4, 4), dtype=np.int64)
    for x0 in (0, 4, 8):
        structure[x0:x0 + 2] = rng.integers(1, 5, size=(2, 4, 4))
    pos, dense, compact, _ = _design(structure, 11)
    assert compact.shape[1] == 96
    x = np.arange(160) // 16
    pos = pos.copy()
    pos[0, x >= 8] -= 1.7 * L
    pos = pos + rng.normal(0, 2e-4, pos.shape).astype(np.float32)
    pos = torch.as_tensor(pos[None])
    scale = torch.full((1, 160), L)
    compact = torch.as_tensor(compact[None])
    ref = fr.pair_contact_forces_compact_plain(pos, scale, compact)
    got, counts = _alone(pair_lib, pos, scale, compact)
    assert _rel(got, ref) <= K2_REL_TOL
    assert torch.equal(got, _alone(pair_lib, pos, scale, torch.as_tensor(dense[None]))[0])
    assert counts[0] > 0 and counts[1] > 0
    idx = compact[:, 0]
    assert counts == fr.pair_tile_census_plain(pos, scale, compact[:, 1:], idx=idx)
    dropped, c_bad = _alone(pair_lib, pos, scale, compact, margin=-0.5)
    assert c_bad[0] < counts[0]
    assert c_bad == fr.pair_tile_census_plain(pos, scale, compact[:, 1:], margin=-0.5, idx=idx)
    assert _rel(dropped, ref) >= GUARD_RATIO * K2_REL_TOL


@pytest.mark.parametrize("materials", [False, True])
def test_k1_steps_the_same_bits_with_either_table(host_lib, materials):  # noqa: F811
    """K1's material instance built by g++, 2 robots of the bench design at
    5^3 shrunk into contact and stirred, 12 steps: with the compact table
    and with the dense one, state and stats equal bit for bit, and the
    contact moved them (the same launch without contact differs)."""
    runs = []
    for compact in (True, False):
        args, kw, _ = bench.packed_workload(2, n=5, collision=True, compact=compact,
                                            materials=materials, device="cpu")
        runs.append(_host_any(host_lib, _stirred(_squeezed(args)), kw, 12))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    free = dict(kw, flags=dict(kw["flags"], collision=False))
    state, body, stats, _ = _stirred(_squeezed(args))
    out_free = _host_any(host_lib, (state, body, stats, None), free, 12)[0]
    assert not torch.equal(out_free, runs[0][0])
