"""Native (C++) host runtime: layer codec, convex hull, mesh descriptors.

The port's copy of the JAX package's `native` module. The reference keeps
its host-side heavy lifting in C++ (tinyxml layer decoding
VX_Object.cpp:1748-1830; qhull invoked via popen for hull volume
VX_MeshUtil.cpp:775-899; deformed-mesh volume/complexity VX_MeshUtil.cpp:
902-1093). `csrc/native.cpp` is compiled by g++ at first use into
`evosoro_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
source and the command line (`ops.build.gxx_library`), and loaded with
ctypes. A failed build raises with g++'s message: no entry point falls back
to numpy. The numpy versions (`_surface_triangles_np` and the others) are
the plain versions the tests hold the library against.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from evosoro_tpu_torch.ops import build

SRC = Path(__file__).resolve().parent / "csrc" / "native.cpp"
# the JAX package's command line, less -march=native: the build directory
# travels with a checkout to other hosts
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib = None


def library():
    """The loaded native library, built if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.gxx_library("evosoro_native", [SRC], GXX_FLAGS)))
        P, i64, i32 = ctypes.POINTER, ctypes.c_int64, ctypes.c_int
        f64 = P(ctypes.c_double)
        for name, restype, argtypes in (
                ("decode_ascii_layer", i32, [ctypes.c_char_p, i64, P(ctypes.c_uint8)]),
                ("encode_ascii_layer", i32, [P(ctypes.c_uint8), i64, ctypes.c_char_p]),
                ("convex_hull_volume", i32, [f64, i64, f64, f64]),
                ("surface_triangles", i64, [P(ctypes.c_uint8), i64, i64, i64,
                                            P(ctypes.c_int32), i64]),
                ("mesh_volume", i32, [f64, i64, P(ctypes.c_int32), i64, f64]),
                ("shape_complexity", i32, [f64, i64, P(ctypes.c_int32), i64, f64])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def native_available() -> bool:
    """True once the library is built and loaded (a failed build raises)."""
    return library() is not None


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"native {what} failed with code {rc}")


# ---------------------------------------------------------------------------
# Layer codec
# ---------------------------------------------------------------------------

def decode_ascii_layer(text: str) -> np.ndarray:
    """'0121…' → uint8 ids (reference: VX_Object.cpp ASCII_READABLE path).
    A character below '0' raises (the JAX package's numpy fallback wraps
    it around instead)."""
    data = text.encode()
    out = np.empty(len(data), dtype=np.uint8)
    if library().decode_ascii_layer(data, ctypes.c_int64(len(data)),
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))):
        raise ValueError("layer text holds a character below '0'")
    return out


def _decode_ascii_layer_np(text: str) -> np.ndarray:
    return np.frombuffer(text.encode(), dtype=np.uint8) - ord("0")


def encode_ascii_layer(ids: np.ndarray) -> str:
    ids = np.ascontiguousarray(ids, dtype=np.uint8)
    out = ctypes.create_string_buffer(int(ids.size))
    _check(library().encode_ascii_layer(
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_int64(ids.size), out),
        "encode_ascii_layer")
    return out.raw.decode()


def _encode_ascii_layer_np(ids: np.ndarray) -> str:
    return (np.ascontiguousarray(ids, dtype=np.uint8) + ord("0")).tobytes().decode("latin1")


# ---------------------------------------------------------------------------
# Convex hull (qhull replacement)
# ---------------------------------------------------------------------------

def convex_hull_volume(points: np.ndarray) -> tuple[float, float]:
    """(volume, area) of the convex hull of an (N,3) point cloud.

    Reference parity target: the two numbers `qhull FS TI <file>` prints that
    VX_MeshUtil.cpp:858-899 parses (total facet area, total volume).
    """
    pts = np.ascontiguousarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3 or pts.shape[0] < 4:
        return 0.0, 0.0
    vol = ctypes.c_double()
    area = ctypes.c_double()
    library().convex_hull_volume(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(pts.shape[0]), ctypes.byref(vol), ctypes.byref(area))
    return vol.value, area.value


def _convex_hull_volume_np(points: np.ndarray) -> tuple[float, float]:
    """scipy's Qhull, the JAX package's numpy fallback."""
    from scipy.spatial import ConvexHull

    pts = np.ascontiguousarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3 or pts.shape[0] < 4:
        return 0.0, 0.0
    h = ConvexHull(pts)
    return float(h.volume), float(h.area)


# ---------------------------------------------------------------------------
# Surface mesh + descriptors
# ---------------------------------------------------------------------------

def surface_triangles(occ: np.ndarray) -> np.ndarray:
    """(T,3) int32 corner-lattice indices of the exposed-face triangles.

    Corner lattice index = (x*(Y+1)+y)*(Z+1)+z for corner (x,y,z) of the
    (X+1,Y+1,Z+1) grid (reference: initializeDeformableMesh,
    VX_MeshUtil.cpp:40-250).
    """
    occ8 = np.ascontiguousarray(np.asarray(occ).astype(np.uint8))
    X, Y, Z = occ8.shape
    max_tris = int(occ8.sum()) * 12 + 12
    out = np.empty((max_tris, 3), dtype=np.int32)
    nt = library().surface_triangles(
        occ8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(X), ctypes.c_int64(Y), ctypes.c_int64(Z),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(max_tris))
    if nt < 0:
        raise RuntimeError(f"native surface_triangles failed with code {nt}")
    return out[:nt].copy()


_FACES = [
    ((+1, 0, 0), [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)]),
    ((-1, 0, 0), [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)]),
    ((0, +1, 0), [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)]),
    ((0, -1, 0), [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)]),
    ((0, 0, +1), [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]),
    ((0, 0, -1), [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)]),
]


def _surface_triangles_np(occ8: np.ndarray) -> np.ndarray:
    X, Y, Z = occ8.shape
    occp = np.pad(occ8, 1)
    tris = []
    for (dx, dy, dz), quad in _FACES:
        exposed = (occ8 > 0) & (
            occp[1 + dx:X + 1 + dx, 1 + dy:Y + 1 + dy, 1 + dz:Z + 1 + dz] == 0
        )
        xs, ys, zs = np.nonzero(exposed)
        if xs.size == 0:
            continue
        q = []
        for cx, cy, cz in quad:
            q.append(((xs + cx) * (Y + 1) + (ys + cy)) * (Z + 1) + (zs + cz))
        q = np.stack(q, axis=1).astype(np.int32)
        tris.append(np.stack([q[:, 0], q[:, 1], q[:, 2]], axis=1))
        tris.append(np.stack([q[:, 0], q[:, 2], q[:, 3]], axis=1))
    if not tris:
        return np.zeros((0, 3), dtype=np.int32)
    return np.concatenate(tris, axis=0)


def mesh_volume(verts: np.ndarray, tris: np.ndarray) -> float:
    """Closed-mesh volume by the divergence theorem
    (reference: VX_MeshUtil.cpp:902-948 computeCurrentRobotVolume)."""
    v = np.ascontiguousarray(verts, dtype=np.float64)
    t = np.ascontiguousarray(tris, dtype=np.int32)
    if not t.size:
        return 0.0
    vol = ctypes.c_double()
    _check(library().mesh_volume(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ctypes.c_int64(v.shape[0]),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.c_int64(t.shape[0]),
        ctypes.byref(vol)), "mesh_volume")
    return vol.value


def _mesh_volume_np(verts: np.ndarray, tris: np.ndarray) -> float:
    v = np.asarray(verts, dtype=np.float64)
    t = np.asarray(tris, dtype=np.int32)
    if not t.size:
        return 0.0
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    return float(abs(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0))


def shape_complexity(verts: np.ndarray, tris: np.ndarray) -> float:
    """Σ_vertices |2π − Σ incident angles| (reference:
    VX_MeshUtil.cpp:949-1093 computeShapeComplexity)."""
    v = np.ascontiguousarray(verts, dtype=np.float64)
    t = np.ascontiguousarray(tris, dtype=np.int32)
    if not t.size:
        return 0.0
    out = ctypes.c_double()
    _check(library().shape_complexity(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ctypes.c_int64(v.shape[0]),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.c_int64(t.shape[0]),
        ctypes.byref(out)), "shape_complexity")
    return out.value


def _shape_complexity_np(verts: np.ndarray, tris: np.ndarray) -> float:
    v = np.asarray(verts, dtype=np.float64)
    t = np.asarray(tris, dtype=np.int32)
    if not t.size:
        return 0.0
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]

    def ang(u, w):
        cu = np.einsum("ij,ij->i", u, w) / (
            np.linalg.norm(u, axis=1) * np.linalg.norm(w, axis=1) + 1e-300
        )
        return np.arccos(np.clip(cu, -1, 1))

    sums = np.zeros(v.shape[0])
    np.add.at(sums, t[:, 0], ang(b - a, c - a))
    np.add.at(sums, t[:, 1], ang(a - b, c - b))
    np.add.at(sums, t[:, 2], ang(a - c, b - c))
    used = np.zeros(v.shape[0], dtype=bool)
    used[t.ravel()] = True
    return float(np.abs(2 * np.pi - sums[used]).sum())
