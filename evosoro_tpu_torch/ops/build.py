"""Build and load the port's CUDA kernels (`ops/csrc/*.cu`).

Each library is compiled by `nvcc` from its source (and the translation
units of `EXTRA_SOURCES`) into a shared library with a plain C interface,
loaded with ctypes. Nothing is built at import: a library is
built at first use into `evosoro_tpu_torch/_build/` (listed in .gitignore),
named by a hash of every file under `csrc/` (sources and the headers they
include), so an edit to a kernel or to a shared header rebuilds it. `build_all`
starts one nvcc per translation unit at once, each into an object file, and
links each library from its objects.

Flags: `-gencode arch=compute_90a,code=sm_90a -O3`, no `--use_fast_math`
(sinf, acosf, sqrtf and division stay IEEE-accurate) and `-fmad=false`:
the kernels are held against PyTorch's eager ops, which round every
multiply and add separately, so contraction into FMA is turned off.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each library's launcher: (name, argtypes)
SIGNATURES = {
    "pair_contact": ("pair_contact_forces", [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P,
                                             _P, _P]),
    "fused_rollout": ("fused_rollout", [
        _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P,
        _P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P]),
    "fused_rollout_bwd": ("fused_rollout_bwd", [
        _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P,
        _P, _P, _I, _P, _I, _P]),
    "fma_peak": ("fma_peak", [_P, _P, _I, _I, ctypes.c_float, ctypes.c_float, _P]),
}

# translation units a library links beside its own `<name>.cu`: K1's
# device-memory instances, K1's kernels with the resident state, K1's
# material instances in water and with growth (each variant's shared and
# device-memory kernels a unit each), B4's material instances and the
# compact pass's own launch compile apart from
# the other kernels, so K1's and K2's keep their machine code and the units
# build side by side
EXTRA_SOURCES = {"fused_rollout": ("fused_rollout_gmem.cu", "fused_rollout_res.cu",
                                   "fused_rollout_mat_face.cu", "fused_rollout_mat_face_gmem.cu",
                                   "fused_rollout_mat_mesh.cu", "fused_rollout_mat_mesh_gmem.cu",
                                   "fused_rollout_mat_devo.cu", "fused_rollout_mat_devo_gmem.cu"),
                 "fused_rollout_bwd": ("fused_rollout_bwd_mat.cu", "fused_rollout_bwd_matvar.cu"),
                 "pair_contact": ("pair_contact_compact.cu",)}

_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


@contextlib.contextmanager
def build_lock(directory: Path = BUILD_DIR, name: str = ".build.lock"):
    """Hold an exclusive file lock in `directory` (created if missing), so
    that processes sharing a build directory (pytest workers, the ranks of
    a distributed run) build one at a time and each finds what the one
    before it built."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / name, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names=tuple(SIGNATURES)) -> float:
    """Compile every missing library: one nvcc process per translation unit,
    all started together, then one link per library, under `build_lock`,
    so another process never starts nvcc into the same directory at the
    same time. Returns the wall seconds; raises on any failure."""
    t0 = time.time()
    with build_lock():
        _build_missing(names)
    return time.time() - t0


def _build_missing(names):
    jobs = []  # (name, library path, [(object, log, process)])
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        units = []
        for src in (f"{name}.cu",) + EXTRA_SOURCES.get(name, ()):
            obj = out.with_suffix(f".{Path(src).stem}.{os.getpid()}.o")
            log = obj.with_suffix(".log")
            with open(log, "w") as f:
                proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                                         str(CSRC / src)], stdout=f, stderr=subprocess.STDOUT)
            units.append((obj, log, proc))
        jobs.append((name, out, units))
    failed = []
    for name, out, units in jobs:
        rc = max(proc.wait() for _, _, proc in units)
        text = "".join(log.read_text() for _, log, _ in units)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if rc == 0:
            link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                                   *(str(obj) for obj, _, _ in units)],
                                  capture_output=True, text=True)
            text += link.stdout + link.stderr
            rc = link.returncode
        out.with_suffix(".log").write_text(text)
        for obj, log, _ in units:
            obj.unlink(missing_ok=True)
            log.unlink(missing_ok=True)
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n" + text[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def gxx_library(name: str, sources, flags, inputs=(), directory: Path = BUILD_DIR,
                timeout: float = 600) -> Path:
    """A shared library built by g++ from `sources` with `flags`, at a path
    named by a hash of the sources, of the files in `inputs` (headers they
    include) and of the command line, built when missing under
    `build_lock` (written to a temporary name and renamed into place).
    Raises with g++'s message when the build fails, and when g++ runs past
    `timeout` seconds."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"{name}: g++ not found")
    h = hashlib.sha256()
    for f in sorted({Path(p) for p in (*sources, *inputs)}):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    out = Path(directory) / f"lib{name}-{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    with build_lock(Path(directory)):
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run([gxx, *flags, "-o", str(tmp), *map(str, sources)],
                               capture_output=True, text=True, timeout=timeout)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{name}: g++ exit {r.returncode}\n{r.stderr[-4000:]}")
            os.replace(tmp, out)
    return out


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, shared memory and spills) of a build."""
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def sass_count(name: str, opcode: str) -> int:
    """How many `opcode` instructions the built library's machine code
    holds (`cuobjdump -sass`, a part of the CUDA toolkit)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found: counting instructions needs "
                           "the CUDA toolkit")
    out = subprocess.run([tool, "-sass", str(_lib_path(name))],
                         capture_output=True, text=True, check=True, timeout=300)
    return sum(1 for ln in out.stdout.splitlines() if f" {opcode}" in ln)


def library(name: str):
    """The loaded launcher function of library `name`, built if needed."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = (lib, fn)
    return _libs[name][1]


def function(name: str, fn_name: str, argtypes):
    """Another function of library `name`'s C interface (returning an int),
    built if needed."""
    library(name)
    fn = getattr(_libs[name][0], fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def check(rc: int, what: str):
    """Raise if a launcher returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
