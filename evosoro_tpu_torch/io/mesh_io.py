"""Surface-mesh export/import: STL (binary + ASCII) and OBJ.

The port's copy of `evosoro_tpu.io.mesh_io` (numpy only): the files it
writes are byte-equal to the JAX package's.

Parity with the reference's mesh IO (reference: VX_MeshUtil.cpp:492-731
STL import/export of the deformed robot surface; used for visualization and
downstream shape analysis). Works on the (verts, tris) pairs produced by
`evosoro_tpu_torch.core.shape.deformed_mesh`.
"""

from __future__ import annotations

import struct

import numpy as np


def write_stl(path: str, verts: np.ndarray, tris: np.ndarray,
              binary: bool = True, name: str = "evosoro_tpu") -> None:
    """Write a triangle mesh as STL (reference: CMesh::SaveSTL)."""
    v = np.asarray(verts, dtype=np.float64)
    t = np.asarray(tris, dtype=np.int64)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    n = np.cross(b - a, c - a)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(ln > 0, n / np.where(ln > 0, ln, 1.0), 0.0)

    if binary:
        with open(path, "wb") as f:
            f.write(name.encode()[:80].ljust(80, b"\0"))
            f.write(struct.pack("<I", len(t)))
            for i in range(len(t)):
                f.write(struct.pack("<3f", *n[i]))
                f.write(struct.pack("<3f", *a[i]))
                f.write(struct.pack("<3f", *b[i]))
                f.write(struct.pack("<3f", *c[i]))
                f.write(struct.pack("<H", 0))
    else:
        with open(path, "w") as f:
            f.write(f"solid {name}\n")
            for i in range(len(t)):
                f.write(f"  facet normal {n[i,0]:.8e} {n[i,1]:.8e} {n[i,2]:.8e}\n")
                f.write("    outer loop\n")
                for p in (a[i], b[i], c[i]):
                    f.write(f"      vertex {p[0]:.8e} {p[1]:.8e} {p[2]:.8e}\n")
                f.write("    endloop\n  endfacet\n")
            f.write(f"endsolid {name}\n")


def read_stl(path: str):
    """Read an STL file (binary or ASCII) → (verts (V,3), tris (T,3)) with
    exact-duplicate vertices welded (reference: CMesh::LoadSTL)."""
    with open(path, "rb") as f:
        head = f.read(84)
        if len(head) < 84 or head[:5].lower() == b"solid" and _is_ascii(path):
            return _read_stl_ascii(path)
        (ntri,) = struct.unpack("<I", head[80:84])
        data = np.frombuffer(f.read(ntri * 50), dtype=np.uint8)
    rec = data.reshape(ntri, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(ntri, 12)
    pts = floats[:, 3:12].reshape(ntri * 3, 3).astype(np.float64)
    verts, inverse = np.unique(pts.round(decimals=9), axis=0,
                               return_inverse=True)
    tris = inverse.reshape(ntri, 3).astype(np.int32)
    return verts, tris


def _is_ascii(path):
    with open(path, "rb") as f:
        chunk = f.read(512)
    try:
        chunk.decode("ascii")
        return b"facet" in chunk
    except UnicodeDecodeError:
        return False


def _read_stl_ascii(path):
    pts = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts[:1] == ["vertex"]:
                pts.append([float(x) for x in parts[1:4]])
    pts = np.asarray(pts, dtype=np.float64)
    ntri = len(pts) // 3
    verts, inverse = np.unique(pts.round(decimals=9), axis=0,
                               return_inverse=True)
    tris = inverse[: ntri * 3].reshape(ntri, 3).astype(np.int32)
    return verts, tris


def write_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """Wavefront OBJ export (1-indexed faces)."""
    v = np.asarray(verts, dtype=np.float64)
    t = np.asarray(tris, dtype=np.int64)
    with open(path, "w") as f:
        f.write("# evosoro_tpu deformed surface mesh\n")
        for p in v:
            f.write(f"v {p[0]:.8e} {p[1]:.8e} {p[2]:.8e}\n")
        for a, b, c in t + 1:
            f.write(f"f {a} {b} {c}\n")


def export_deformed_mesh(path: str, state, body, fmt: str | None = None):
    """One-call export of the current deformed robot surface."""
    from evosoro_tpu_torch.core.shape import deformed_mesh

    verts, tris = deformed_mesh(state, body)
    fmt = fmt or ("obj" if path.endswith(".obj") else "stl")
    if fmt == "obj":
        write_obj(path, verts, tris)
    else:
        write_stl(path, verts, tris)
    return verts, tris


def export_smooth_mesh(path: str, structure, lattice_dim: float = 1.0,
                       fmt: str | None = None):
    """Export the marching-tetrahedra smoothed surface of a voxel design
    (the reference GUI's MarchCube.cpp capability)."""
    from evosoro_tpu_torch.viz.marching import smooth_structure_mesh

    verts, tris = smooth_structure_mesh(structure, lattice_dim)
    fmt = fmt or ("obj" if path.endswith(".obj") else "stl")
    if fmt == "obj":
        write_obj(path, verts, tris)
    else:
        write_stl(path, verts, tris)
    return verts, tris
