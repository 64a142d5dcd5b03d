"""Hold this checkout's kernel libraries against another checkout's, on the
card.

    python -m evosoro_tpu_torch.buildcmp OTHER_CHECKOUT

Builds `fused_rollout`, `fused_rollout_bwd` and `pair_contact` in both
trees (`ops/build.py`) and compares the machine code of every kernel
function the two trees' libraries hold (`cuobjdump -sass`, addresses
stripped). A function whose parameters changed keeps its name and is
compared under it; a kernel that gained a last template bit (K1's DENSE)
is compared, with the bit off, with the other tree's instance of its other
arguments (K1's kernels gained RES, the resident state, last). The report
sorts the functions that differ into those that differ by design
(`BY_DESIGN`: K1's kernels, which run `ops/csrc/k1_step.cuh`'s step) and
the others, checks that the functions only this tree holds are the ones
`NEW_KERNELS` lists (K1's kernels with the resident state, and its
material kernel, which took the volume instances in as `VOL`: the other
tree's `fused_rollout_vol_kernel` is only there), and that every kernel of
B4 and K2 is compared and unchanged (`b4_k2_unchanged`). A function that
differs is held to the same bits by `chip_smoke.py --land`'s digests (K1
and B4 on land, the material instance) and `--diff`'s (B4's variants),
run in both trees.
Then it times the material instance
on 1024 x 10^3 x 200 steps (no contact) through each `fused_rollout` in one
process, in turns on the same tensors (other, this, this, other, three
times; `bench.time_call` each), and checks that both give the same bits;
the same, twice over, for K1's device-memory twins (`bench.big_body_workload`:
1024 x 12^3 x 200 without contact, 32 x 12^3 and 32 x 13^3 x 100 with it)
and for the 12^3 fused-SQP re-plan (`bench.sqp(n=12)`, whose K1 segments
run the twins). A process's own layout moves a launch's time by up to ~1 %
from one process to the next, so two libraries are timed in one. The other
tree's launcher may lack trailing arguments that this one adds before the
stream; they are dropped for it. It also reports the registers and spills
ptxas gave every K1 and B4 kernel in both trees (`ptxas`). Prints one JSON
object.
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
K1_KERNELS = ("fused_rollout_kernel", "fused_rollout_mat_kernel", "fused_rollout_vol_kernel",
              "fused_rollout_gmem_kernel", "fused_rollout_mat_gmem_kernel")
# the kernel functions this tree adds to its parent's libraries: K1's
# instances with the resident state and its merged material kernel
NEW_KERNELS = ("fused_rollout_kernel", "fused_rollout_mat_kernel")
# the kernel functions whose machine code this tree changes on purpose: K1's
BY_DESIGN = K1_KERNELS
_BUILD = ("from evosoro_tpu_torch.ops import build; build.build_all(%r); "
          "[print(build._lib_path(n)) for n in %r]" % (LIBS, LIBS))


def _sass(lib: str) -> dict:
    """{kernel function: (instructions, sha256 of the SASS)} of a library."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None and "/*" in ln:
            cur.append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).split(";")[0].strip())
    return {k: (len(v), hashlib.sha256("\n".join(v).encode()).hexdigest()[:12])
            for k, v in funcs.items()}


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


def launchers(other: str, lib=None) -> dict:
    """K1's launchers {"this": ..., "other": ...}: this tree's and checkout
    `other`'s (its `fused_rollout` library `lib`, built there if not given),
    the other called with its own signature (its build.py): it may lack
    trailing arguments that this one adds before the stream."""
    from evosoro_tpu_torch.ops import build

    lib = lib or _built(Path(other).resolve())[0]
    spec = importlib.util.spec_from_file_location(
        "other_build", Path(other) / "evosoro_tpu_torch" / "ops" / "build.py")
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    argtypes = other_build.SIGNATURES["fused_rollout"][1]
    ofn = ctypes.CDLL(lib).fused_rollout
    ofn.argtypes, ofn.restype = argtypes, ctypes.c_int
    n = len(argtypes)
    return {"this": build.library("fused_rollout"),
            "other": lambda *a: ofn(*a[:n - 1], a[-1])}


def in_turns(arms: dict, timed, run, rounds=3):
    """{arm: [ms, ...]} of `timed()` through each arm's K1 launcher in
    turns, the arms in order and back (other, this, this, other) x rounds,
    and whether `run()` gave every arm the same bits. An arm is a launcher
    (`launchers`), or (launcher, False) to run it with the robot's state
    kept in device memory (`fused_rollout.k1_resident` false)."""
    from unittest import mock

    import torch

    from evosoro_tpu_torch.ops import build
    from evosoro_tpu_torch.ops import fused_rollout as fr

    times, outs = {k: [] for k in arms}, {}
    for name in (list(arms) + list(arms)[::-1]) * rounds:
        fn, resident = arms[name] if isinstance(arms[name], tuple) else (arms[name], True)
        build._libs["fused_rollout"] = (None, fn)
        with mock.patch.object(fr, "k1_resident", fr.k1_resident if resident
                               else (lambda *a, **k: False)):
            times[name].append(timed())
            outs.setdefault(name, run())
    build._libs.pop("fused_rollout")
    first = next(iter(outs.values()))
    return times, all(torch.equal(a, b) for o in outs.values() for a, b in zip(o, first))


def main(other: str) -> dict:
    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.ops import fused_rollout as fr

    paths = {"this": _built(Path(__file__).resolve().parents[1]),
             "other": _built(Path(other).resolve())}
    libs = {k: v[0] for k, v in paths.items()}
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
    differing = [k for k in shared if sass["this"][k] != sass["other"][k]]
    rec = dict(libraries=paths, kernels_compared=len(shared), kernels_differing=differing,
               differing_by_design=[k for k in differing if _name(k) in BY_DESIGN],
               differing_otherwise=[k for k in differing if _name(k) not in BY_DESIGN],
               kernels_only_here=sorted(set(sass["this"]) - set(sass["other"])),
               kernels_only_there=sorted(set(sass["other"]) - set(sass["this"])))
    rec["new_kernels_as_listed"] = {_name(f) for f in rec["kernels_only_here"]} \
        == set(NEW_KERNELS)
    # B4's and K2's kernels: every one compared, none differing
    others = [k for k in set(sass["this"]) | set(sass["other"]) if _name(k) not in K1_KERNELS]
    rec["b4_k2_compared"] = sorted(_name(k) for k in others)
    rec["b4_k2_unchanged"] = bool(others) and all(
        k in shared and k not in differing for k in others)

    calls = launchers(other, libs["other"])
    arms = {"other": calls["other"], "this": calls["this"]}

    def launch(args, kw, steps, groups=2, reps=3):
        def run():
            return fr.fused_call(*args, num_steps=steps, **kw)

        return lambda: bench.time_call(run, groups, reps), run

    args, kw, _ = bench.packed_workload(1024, device="cuda", materials=True)
    times, same = in_turns(arms, *launch(args, kw, 200))
    rec.update(card=bench.card_info(), material_1024x10_3x200_ms=times, outputs_bit_equal=same)
    # the device-memory twins (bodies past shared memory) and the 12^3 SQP
    # solve, whose K1 segments run them
    twins = {}
    for label, (batch, n, coll, steps) in {
            "1024 x 12^3 x 200, contact off": (1024, 12, False, 200),
            "32 x 12^3 x 100, contact on": (32, 12, True, 100),
            "32 x 13^3 x 100, contact on": (32, 13, True, 100)}.items():
        args, kw, _ = bench.big_body_workload(batch, n=n, collision=coll, device="cuda")
        twins[label] = dict(zip(("ms", "outputs_bit_equal"),
                                in_turns(arms, *launch(args, kw, steps, reps=2), rounds=2)))
        del args
    twins["SQP re-plan at 12^3 (ms per re-plan)"] = dict(
        ms=in_turns(arms, lambda: bench.sqp(device="cuda", n=12)["ms_per_solve"], tuple, 2)[0])
    rec.update(device_memory_twins=twins, ptxas=_ptxas_tables(paths))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1])
