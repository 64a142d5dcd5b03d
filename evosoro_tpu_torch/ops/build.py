"""Build and load the port's CUDA kernels (`ops/csrc/*.cu`).

Each source is compiled by `nvcc` into its own shared library with a plain
C interface, loaded with ctypes. Nothing is built at import: a library is
built at first use into `evosoro_tpu_torch/_build/` (listed in .gitignore),
named by a hash of every file under `csrc/` (sources and the headers they
include), so an edit to a kernel or to a shared header rebuilds it. `build_all`
starts one nvcc per source at once.

Flags: `-gencode arch=compute_90a,code=sm_90a -O3`, no `--use_fast_math`
(sinf, acosf, sqrtf and division stay IEEE-accurate) and `-fmad=false`:
the kernels are held against PyTorch's eager ops, which round every
multiply and add separately, so contraction into FMA is turned off.
"""

from __future__ import annotations

import ctypes
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
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each library's launcher: (name, argtypes)
SIGNATURES = {
    "pair_contact": ("pair_contact_forces", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "fused_rollout": ("fused_rollout", [
        _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P,
        _P, _I, _I, _P, _I, _I, _P, _P, _P, _P]),
    "fused_rollout_bwd": ("fused_rollout_bwd", [
        _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P,
        _P]),
    "fma_peak": ("fma_peak", [_P, _P, _I, _I, ctypes.c_float, ctypes.c_float, _P]),
}

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


def build_all(names=tuple(SIGNATURES)) -> float:
    """Compile every missing library, one nvcc process per source, all
    started together. Returns the wall seconds; raises on any failure."""
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.time() - t0


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


def check(rc: int, what: str):
    """Raise if a launcher returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
