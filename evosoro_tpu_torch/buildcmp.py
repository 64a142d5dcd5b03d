"""Hold this checkout's kernel libraries against another checkout's, on the
card.

    python -m evosoro_tpu_torch.buildcmp OTHER_CHECKOUT

Builds `fused_rollout`, `fused_rollout_bwd` and `pair_contact` in both
trees (`ops/build.py`) and compares the machine code of every kernel
function the two trees' libraries hold (`cuobjdump -sass`, addresses
stripped). A function whose parameters changed keeps its name and is
compared under it; a kernel that gained a last template bit (K1's DENSE)
is compared, with the bit off, with the other tree's instance of its other
arguments. The report sorts the functions that differ into those that
differ by design (`BY_DESIGN`: K1's kernels without the dense pair pass,
which no longer hold the old row walk, K2's pass kernel, and B4's, whose
recompute no longer holds it either) and the others, and checks that the
functions only this tree holds are the ones `NEW_KERNELS` lists (K2's mask
launch and K1's DENSE instances, which inline the pass of
`ops/csrc/pair_contact.cuh`). A function that differs is held to the
same bits by `chip_smoke.py --land`'s digests (K1 and B4 on land, the
material instance) and `--diff`'s (B4's variants), run in both trees.
Then it times the material instance
on 1024 x 10^3 x 200 steps (no contact) through each `fused_rollout` in one
process, in turns on the same tensors (other, this, this, other, three
times; `bench.time_call` each), and checks that both give the same bits. A
process's own layout moves a launch's time by up to ~1 % from one process
to the next, so two libraries are timed in one. The other tree's launcher
may lack trailing arguments that this one adds before the stream; they are
dropped for it. Prints one JSON object.
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
# the kernel functions this tree adds to its parent's libraries: K2's mask
# launch, and K1's DENSE instances (the names of K1's kernels)
NEW_KERNELS = ("pair_mask_kernel",) + K1_KERNELS
# the kernel functions whose machine code this tree changes on purpose: K1's
# and B4's, which lost the old row walk, and K2's pass
BY_DESIGN = K1_KERNELS + ("pair_contact_kernel", "fused_rollout_bwd_kernel",
                          "fused_rollout_bwd_var_kernel", "fused_rollout_bwd_gmem_kernel",
                          "fused_rollout_bwd_mat_kernel", "fused_rollout_bwd_mat_gmem_kernel")
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


def main(other: str) -> dict:
    import torch

    from evosoro_tpu_torch import bench
    from evosoro_tpu_torch.ops import build
    from evosoro_tpu_torch.ops import fused_rollout as fr

    here = Path(__file__).resolve().parents[1]
    paths = {}
    for name, root in (("this", here), ("other", Path(other).resolve())):
        r = subprocess.run([sys.executable, "-c", _BUILD], cwd=root, capture_output=True,
                           text=True, check=True)
        paths[name] = r.stdout.strip().splitlines()[-len(LIBS):]
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

    # the other tree's launcher signature, from its own build.py
    spec = importlib.util.spec_from_file_location(
        "other_build", Path(other) / "evosoro_tpu_torch" / "ops" / "build.py")
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    argtypes = other_build.SIGNATURES["fused_rollout"][1]
    ofn = ctypes.CDLL(libs["other"]).fused_rollout
    ofn.argtypes, ofn.restype = argtypes, ctypes.c_int
    n = len(argtypes)
    calls = {"this": build.library("fused_rollout"),
             "other": lambda *a: ofn(*a[:n - 1], a[-1])}
    args, kw, _ = bench.packed_workload(1024, device="cuda", materials=True)
    times, outs = {"other": [], "this": []}, {}
    for name in ("other", "this", "this", "other") * 3:
        build._libs["fused_rollout"] = (None, calls[name])
        times[name].append(bench.time_call(
            lambda: fr.fused_call(*args, num_steps=200, **kw), 2, 3))
        outs.setdefault(name, fr.fused_call(*args, num_steps=200, **kw))
    build._libs.pop("fused_rollout")
    rec.update(card=bench.card_info(), material_1024x10_3x200_ms=times,
               outputs_bit_equal=all(torch.equal(a, b)
                                     for a, b in zip(outs["this"], outs["other"])))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1])
