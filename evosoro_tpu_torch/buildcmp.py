"""Hold this checkout's kernel libraries against another checkout's, on the
card.

    python -m evosoro_tpu_torch.buildcmp OTHER_CHECKOUT

Builds `fused_rollout`, `fused_rollout_bwd` and `pair_contact` in both
trees (`ops/build.py`) and compares the machine code of every kernel
function the two trees' libraries hold (`cuobjdump -sass`, addresses
stripped). A function whose parameters changed keeps its name and is
compared under it; a kernel that gained a last template bit is compared,
with the bit off, with the other tree's instance of its other arguments.
The report sorts the functions that differ into those that differ by
design (`BY_DESIGN`: none of the parent's kernels; it names K1's and B4's
material instances in water and with growth, new in this tree) and the
others (with where each one's SASS first parts from the other tree's), checks that the functions only one tree holds change by design
(this tree's new instances), and
that every other kernel of K1, B4 and K2 is compared and unchanged
(`k1_k2_unchanged`). It also reports the registers and spills ptxas gave
every K1 and B4 kernel in both trees (`ptxas`). Prints one JSON object.

    python -m evosoro_tpu_torch.buildcmp --ptx OTHER_CHECKOUT [UNIT ...]

compiles K1's translation units (or those named) of both trees to PTX and
prints, for each kernel whose PTX differs, the lines that differ
(`ptx_diff`), one JSON object: where a kernel's SASS moved, whether its
source did.

    python -m evosoro_tpu_torch.buildcmp --b4-split ARM=CHECKOUT ...

times a land B4 launch whole and its forward recompute alone in each
checkout, in turns (`b4_split`; a checkout whose B4 has `b4_recompute`),
and prints one JSON object.

`launchers` and `in_turns` serve `chip_smoke.py --step --against` and
`--diff --against`, which time a kernel through both trees' libraries in
one process (a process's own layout moves a launch's time by up to ~1 %
from one process to the next). The other tree's launcher may lack
trailing arguments that this one adds before the stream; they are dropped
for it. `sqp_k1_launch` and `sqp_b4_launch` build the fused SQP solve's K1
and B4 launches that those comparisons and `chip_smoke.py` time.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

LIBS = ("fused_rollout", "fused_rollout_bwd", "pair_contact")
# the kernel functions whose machine code this tree changes on purpose, by
# name, with the template arguments of the instances that change (None:
# every instance): K1's and B4's material instances in water and with
# growth, new in this tree (csrc/fused_rollout_matvar.cuh,
# fused_rollout_bwd_matvar.cu). Every kernel the parent holds keeps its
# machine code.
BY_DESIGN = {"fused_rollout_matvar_kernel": None, "fused_rollout_bwd_matvar_kernel": None}
_BUILD = ("from evosoro_tpu_torch.ops import build; build.build_all(%r); "
          "[print(build._lib_path(n)) for n in %r]" % (LIBS, LIBS))


def _sass(lib: str) -> dict:
    """{kernel function: (instructions, sha256 of the SASS, the SASS lines)}
    of a library."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None and "/*" in ln:
            cur.append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).split(";")[0].strip())
    return {k: (len(v), hashlib.sha256("\n".join(v).encode()).hexdigest()[:12], v)
            for k, v in funcs.items()}


def _first_difference(a: list, b: list) -> dict:
    """Where two functions' SASS lines first part: the index, each tree's
    line there, and each tree's instruction count."""
    i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return dict(index=i, this=a[i] if i < len(a) else None, other=b[i] if i < len(b) else None,
                instructions=[len(a), len(b)])


def _name(mangled: str) -> str:
    """A kernel's name from its mangled one, _Z<length><name><parameters>."""
    m = re.match(r"_Z(\d+)", mangled)
    return mangled[m.end():m.end() + int(m.group(1))] if m else mangled


def _label(mangled: str) -> str:
    """A kernel's name with its template arguments, fused_rollout_kernel<0,1,0,1>."""
    name = _name(mangled)
    m = re.match(r"I((?:L[ib]\d+E)+)E", mangled[mangled.find(name) + len(name):])
    if not m:
        return name
    return name + "<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(1))) + ">"


def _by_design(mangled: str) -> bool:
    """Whether a kernel function's machine code changes on purpose
    (`BY_DESIGN`)."""
    name = _name(mangled)
    if name not in BY_DESIGN:
        return False
    rule, args = BY_DESIGN[name], _label(mangled)[len(name) + 1:-1].split(",")
    return rule is None or len(args) < 3 or rule(args)


def _ptxas_tables(paths: dict) -> dict:
    """{tree: {kernel<template arguments>: [registers, spill stores, spill
    loads]}} of K1's and B4's kernels, from each library's ptxas report
    (the build's log beside it)."""
    out = {}
    for tree, libs in paths.items():
        table, cur = {}, None
        for lib in libs:
            log = Path(lib).with_suffix(".log")
            for ln in (log.read_text() if log.exists() else "").splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", ln)
                if m:
                    cur = _label(m.group(1)) if _name(m.group(1)).startswith(
                        "fused_rollout") else None
                    if cur:
                        table[cur] = [None, None, None]
                elif cur and "spill stores" in ln:
                    table[cur][1:] = [int(x) for x in re.findall(r"(\d+) bytes spill", ln)]
                elif cur and "registers" in ln:
                    table[cur][0] = int(re.search(r"Used (\d+) registers", ln).group(1))
        out[tree] = table
    return out


def _built(root) -> list:
    """The library paths of LIBS in checkout `root`, built there if needed."""
    r = subprocess.run([sys.executable, "-c", _BUILD], cwd=root, capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[-len(LIBS):]


def launchers(other: str, lib=None, name="fused_rollout") -> dict:
    """The launchers of library `name` (K1's unless given) {"this": ...,
    "other": ...}: this tree's and checkout `other`'s (its library `lib`,
    built there if not given), the other called with its own signature (its
    build.py): it may lack trailing arguments that this one adds before the
    stream."""
    from evosoro_tpu_torch.ops import build

    lib = lib or _built(Path(other).resolve())[LIBS.index(name)]
    spec = importlib.util.spec_from_file_location(
        "other_build", Path(other) / "evosoro_tpu_torch" / "ops" / "build.py")
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    argtypes = other_build.SIGNATURES[name][1]
    ofn = getattr(ctypes.CDLL(lib), name)
    ofn.argtypes, ofn.restype = argtypes, ctypes.c_int
    n = len(argtypes)
    return {"this": build.library(name), "other": lambda *a: ofn(*a[:n - 1], a[-1])}


def in_turns(arms: dict, timed, run, rounds=3, lib="fused_rollout", across=None):
    """{arm: [ms, ...]} of `timed()` through each arm's launcher of library
    `lib` in turns, the arms in order and back (other, this, this, other) x
    rounds, and whether `run()` gave the same bits on every turn of every
    arm (of the arms named in `across`, when given). An arm is a
    launcher (`launchers`), or (launcher, False) to run K1
    with the robot's state kept in device memory (`fused_rollout.k1_resident`
    false), or (launcher, context) to run it inside `context()`. The
    library's other functions (its launch shapes) stay this tree's."""
    from unittest import mock

    import torch

    from evosoro_tpu_torch.ops import build
    from evosoro_tpu_torch.ops import fused_rollout as fr

    build.library(lib)
    own = build._libs[lib]
    times, outs = {k: [] for k in arms}, []
    try:
        for name in (list(arms) + list(arms)[::-1]) * rounds:
            fn, opt = arms[name] if isinstance(arms[name], tuple) else (arms[name], True)
            build._libs[lib] = (own[0], fn)
            ctx = opt() if callable(opt) else mock.patch.object(
                fr, "k1_resident", fr.k1_resident if opt else (lambda *a, **k: False))
            with ctx:
                times[name].append(timed())
                out = run()
                if across is None or name in across:
                    outs.append(out)
    finally:
        build._libs[lib] = own
    return times, all(torch.equal(a, b) for o in outs for a, b in zip(o, outs[0]))


# B4's forward recompute alone, built against a checkout's csrc
# (`b4_split`): the land recompute into the tape as that tree's
# reverse_segment runs it (b4_recompute), under that tree's B4 bound and
# block size. The reverse sweep is left out, so its registers do not weigh
# on the recompute here as they do in B4's kernel.
_PROBE = r"""
#include "fused_rollout_bwd.cuh"
__global__ void __launch_bounds__(B4_BOUND)
b4_recompute_probe_kernel(const float* __restrict__ state_all,
                          const float* __restrict__ body_all, int body_batched,
                          const float* __restrict__ stats_all,
                          const float* __restrict__ ctrl_all, int n_knots, int knot_steps,
                          int step_base, int X, int Y, int Z, int num_steps, Params p,
                          int flags, float* tape_all, float* tape_t_all) {
    extern __shared__ float sh[];
    __shared__ int taken;
    const int V = X * Y * Z;
    const int b = blockIdx.x;
    Robot r = load_robot(stats_all + (size_t)b * C_STAT);
    b4_recompute<V_LAND>(state_all + (size_t)b * C_S * V,
                         body_all + (body_batched ? (size_t)b * C_B * V : 0),
                         ctrl_all + (size_t)b * n_knots * V, n_knots, knot_steps, step_base, X,
                         Y, Z, num_steps, p, flags, r,
                         tape_all + (size_t)b * (num_steps + 1) * NT * V,
                         tape_t_all + (size_t)b * num_steps, sh, &taken);
}
extern "C" int b4_recompute_probe(const float* state, const float* body, int body_batched,
                                  const float* stats, const float* ctrl, int n_knots,
                                  int knot_steps, int step_base, int B, int X, int Y, int Z,
                                  int num_steps, const float* params, int flags, float* tape,
                                  float* tape_t, void* stream) {
    Params p;
    memcpy(&p, params, sizeof(float) * N_PARAMS);
    const int V = X * Y * Z;
    const size_t smem = (size_t)BF * V * sizeof(float);
    int rc = (int)cudaFuncSetAttribute(b4_recompute_probe_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
    b4_recompute_probe_kernel<<<B, b4_threads(V), smem, (cudaStream_t)stream>>>(
        state, body, body_batched, stats, ctrl, n_knots, knot_steps, step_base, X, Y, Z,
        num_steps, p, flags, tape, tape_t);
    return (int)cudaGetLastError();
}
"""


def _probe(root):
    """The B4 recompute probe (`_PROBE`) of checkout `root`, built there
    with its build flags into its `_build/`, as a ctypes function."""
    root = Path(root).resolve()
    spec = importlib.util.spec_from_file_location(
        "probe_build", root / "evosoro_tpu_torch" / "ops" / "build.py")
    b = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(b)
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = b.BUILD_DIR / "b4_recompute_probe.cu"
    src.write_text(_PROBE)
    lib = b.BUILD_DIR / "libb4_recompute_probe.so"
    subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-shared", "-I", str(b.CSRC), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).b4_recompute_probe
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [P, P, I, P, P] + [I] * 8 + [P, I, P, P, P], ctypes.c_int
    return fn


def sqp_k1_launch(n=10, B=8, K=8, **wkw):
    """K1's launch of the fused SQP solve on `bench.sqp_workload(n, **wkw)`
    from rest: segmented mode on a 200-step clock, seg_base 0, `K` knots of
    random controls (uniform in +-0.05, seed 31, different for every
    robot). Returns (args, launch keywords without num_steps)."""
    import numpy as np
    import torch

    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.core.rollout import init_state
    from evosoro_tpu_torch.ops import fused_rollout as fr

    body, sim, env, dt = bench.sqp_workload(n=n, device="cuda", **wkw)
    V = body.occ.numel()
    state0 = fr.pack_state_single(init_state(body))[None].expand(B, -1, -1).contiguous()
    ctrl = torch.as_tensor(np.random.default_rng(31).uniform(
        -0.05, 0.05, size=(B, K, V)).astype(np.float32), device="cuda")
    kw = dict(grid_shape=tuple(body.occ.shape),
              scalars=fr.kernel_scalars(body.nominal_size, sim, env),
              flags=fr.launch_flags(body, sim, env, collision=False, segmented=True),
              n_knots=K, total_steps=200, control_packed=ctrl, seg_base=0)
    return (state0, fr.pack_body(body), fr.make_stats(body, B, dt, sim, env), None), kw


def sqp_b4_launch(n=10, B=8, K=8, **wkw):
    """B4's launch of the fused SQP solve on `bench.sqp_workload(n, **wkw)`:
    25 steps of a 200-step clock from the state K1 reaches 75 steps into
    `sqp_k1_launch`, with a random cotangent (seed 32). Returns (state,
    body, stats, controls, cotangent, launch keywords)."""
    import numpy as np
    import torch

    from evosoro_tpu_torch.ops import fused_rollout as fr

    args, kw = sqp_k1_launch(n, B, K, **wkw)
    st75, ss75 = fr.fused_call(*args, num_steps=75, **kw)
    ctrl = kw.pop("control_packed")
    kw.pop("seg_base")
    cot = np.random.default_rng(32).standard_normal(st75.shape).astype(np.float32)
    cot[:, fr._TSAVG:] = 0.0
    return (st75, args[1], ss75, ctrl, torch.as_tensor(cot, device="cuda"),
            dict(kw, num_steps=25))


def b4_split(roots: dict, launch=None, rounds=2) -> dict:
    """How a land B4 launch divides between its forward recompute and its
    reverse sweep, in each checkout of `roots` ({arm: path}): B4's launch
    (`sqp_b4_launch` unless given) whole through that tree's
    `fused_rollout_bwd` library, and the recompute alone (`_probe`), each
    timed with CUDA events, the arms in turns (in order and back) x
    `rounds`. The sweep is the difference. Returns {arm: {"whole_ms",
    "recompute_ms", "sweep_ms", "recompute_share"}} (best of each arm's
    turns), and "turns" with every reading."""
    import torch

    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.ops import build
    from evosoro_tpu_torch.ops import fused_rollout as fr

    st, body, stats, ctrl, cot, kw = launch or sqp_b4_launch()
    B, _, V = st.shape
    X, Y, Z = kw["grid_shape"]
    S = kw["num_steps"]
    seg0, knot_steps = fr._knot_clock(kw["flags"], S, kw["n_knots"], ctrl, 75, 200)
    params = fr._k1_params(kw["scalars"], fr.DEFAULT_PRECISION)
    bits = fr._flag_bits(kw["flags"])
    tape = torch.empty((B, S + 1, fr.b4_tape_channels(kw["flags"]), V), device="cuda")
    tape_t = torch.empty((B, S), device="cuda")
    build.library("fused_rollout_bwd")
    own = build._libs["fused_rollout_bwd"]  # this tree's launch shapes stay in use
    arms = {}
    for arm, root in roots.items():
        probe = _probe(root)
        bwd = launchers(root, name="fused_rollout_bwd")["other"]

        def recompute(probe=probe):
            rc = probe(st.data_ptr(), body.data_ptr(), 0, stats.data_ptr(), ctrl.data_ptr(),
                       kw["n_knots"], knot_steps, seg0, B, X, Y, Z, S,
                       params.ctypes.data_as(ctypes.c_void_p), bits, tape.data_ptr(),
                       tape_t.data_ptr(), torch.cuda.current_stream().cuda_stream)
            build.check(rc, "b4_recompute_probe")

        def whole(bwd=bwd):
            build._libs["fused_rollout_bwd"] = (own[0], bwd)
            try:
                fr.fused_bwd_call(st, body, stats, ctrl, 75, cot, **kw)
            finally:
                build._libs["fused_rollout_bwd"] = own

        arms[arm] = (recompute, whole)
    turns = {a: {"whole_ms": [], "recompute_ms": []} for a in arms}
    for arm in (list(arms) + list(arms)[::-1]) * rounds:
        recompute, whole = arms[arm]
        turns[arm]["recompute_ms"].append(bench.time_call(recompute, 3, 20))
        turns[arm]["whole_ms"].append(bench.time_call(whole, 3, 20))
    out = {}
    for arm, t in turns.items():
        w, r = min(t["whole_ms"]), min(t["recompute_ms"])
        out[arm] = dict(whole_ms=w, recompute_ms=r, sweep_ms=w - r, recompute_share=r / w)
    out["turns"] = turns
    return out


def _ptx_kernels(root, unit: str) -> dict:
    """{kernel: its PTX, mangled names stripped} of translation unit `unit`
    of checkout `root`, compiled with that tree's flags (`nvcc -ptx`)."""
    import tempfile

    spec = importlib.util.spec_from_file_location(
        "ptx_build", Path(root) / "evosoro_tpu_torch" / "ops" / "build.py")
    b = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(b)
    flags = [f for f in b.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "unit.ptx"
        subprocess.run([b._nvcc(), *flags, "-ptx", "-o", str(out), str(b.CSRC / unit)],
                       check=True, capture_output=True, text=True)
        text = out.read_text()
    kernels = {}
    for m in re.finditer(r"\.entry (\w+)(.*?\n}\n)", text, re.S):
        body = re.sub(r"_Z\w+", "SYM", m.group(2))
        # labels and local frames are numbered by the function's place in the unit
        body = re.sub(r"(\$L__BB|__local_depot)\d+", r"\1", body)
        kernels[m.group(1)] = body
    return kernels


def ptx_diff(other: str, units=("fused_rollout.cu", "fused_rollout_res.cu",
                                "fused_rollout_gmem.cu")) -> dict:
    """The kernels of `units` whose PTX differs between this tree and
    checkout `other` (a kernel that gained a last template bit compared,
    with it off, under the other's name), each with the lines that differ
    (at most 40, `-` the other tree's, `+` this one's)."""
    import difflib

    out = {}
    for unit in units:
        here = _ptx_kernels(Path(__file__).resolve().parents[1], unit)
        there = _ptx_kernels(Path(other).resolve(), unit)
        here = {f if f in there else f.replace("Lb0EEv", "Ev", 1): v for f, v in here.items()}
        for name in sorted(set(here) & set(there)):
            if here[name] != there[name]:
                d = [ln for ln in difflib.unified_diff(there[name].splitlines(),
                                                       here[name].splitlines(), n=0,
                                                       lineterm="")
                     if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
                out[_label(name)] = dict(unit=unit, changed_lines=len(d), lines=d[:40])
    return out


def main(other: str) -> dict:
    from evosoro_tpu_torch import bench

    paths = {"this": _built(Path(__file__).resolve().parents[1]),
             "other": _built(Path(other).resolve())}
    # kernel function -> (instructions, digest), over the libraries of a tree
    sass = {k: {f: d for lib in v for f, d in _sass(lib).items()} for k, v in paths.items()}
    # a kernel that gained a last template bit, with the bit off, under the
    # other tree's mangled name: I...Lb0EEv -> I...Ev
    here = set(sass["this"]) - set(sass["other"])
    there = set(sass["other"]) - set(sass["this"])
    for f in sorted(here):
        g = f.replace("Lb0EEv", "Ev", 1)
        if g != f and g in there:
            sass["this"][g] = sass["this"].pop(f)
            there.discard(g)
    # a function whose parameters changed, under its name in both trees
    here = set(sass["this"]) - set(sass["other"])
    for f in sorted(here):
        same = [g for g in there if _name(g) == _name(f)]
        if len(same) == 1 and sum(_name(g) == _name(f) for g in here) == 1:
            sass["this"][_name(f)] = sass["this"].pop(f)
            sass["other"][_name(f)] = sass["other"].pop(same[0])
    shared = sorted(set(sass["this"]) & set(sass["other"]))
    differing = [k for k in shared if sass["this"][k][:2] != sass["other"][k][:2]]
    rec = dict(libraries=paths, kernels_compared=len(shared), kernels_differing=differing,
               differing_by_design=[_label(k) for k in differing if _by_design(k)],
               differing_otherwise=[_label(k) for k in differing if not _by_design(k)],
               kernels_only_here=sorted(set(sass["this"]) - set(sass["other"])),
               kernels_only_there=sorted(set(sass["other"]) - set(sass["this"])))
    # the functions one tree holds alone change by design; every other
    # kernel of K1, B4 and K2: compared, none differing
    rec["only_by_design"] = all(_by_design(f) for f in
                                rec["kernels_only_here"] + rec["kernels_only_there"])
    rec["first_difference_otherwise"] = {
        _label(k): _first_difference(sass["this"][k][2], sass["other"][k][2])
        for k in differing if not _by_design(k)}
    others = [k for k in set(sass["this"]) | set(sass["other"]) if not _by_design(k)]
    rec["k1_k2_compared"] = sorted(_label(k) for k in others)
    rec["k1_k2_unchanged"] = bool(others) and all(
        k in shared and k not in differing for k in others)
    rec.update(card=bench.card_info(), ptxas=_ptxas_tables(paths))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    if sys.argv[1] == "--ptx":  # --ptx CHECKOUT [UNIT ...]
        print(json.dumps(ptx_diff(sys.argv[2], *([tuple(sys.argv[3:])] if sys.argv[3:]
                                                   else []))), flush=True)
    elif sys.argv[1] == "--b4-split":  # --b4-split ARM=CHECKOUT ...
        from evosoro_tpu_torch import bench

        split = b4_split(dict(a.split("=", 1) for a in sys.argv[2:]))
        print(json.dumps(dict(b4_split=split, card=bench.card_info())), flush=True)
    else:
        main(sys.argv[1])
