"""Stored outputs of the JAX package for the port's tests: where JAX's side
of a comparison (a Pallas kernel's compile in interpret mode, a jit of a
long rollout) was most of a test's time, a `tests/fixtures/make_*_jax.py`
script writes its outputs beside a digest of its inputs, and the test reads
them after checking the digest of the inputs it builds itself."""

import hashlib

import jax
import numpy as np


def inputs_digest(*trees) -> str:
    """SHA-256 of every array leaf of JAX pytrees (in float64 where
    floating), for checking that a stored JAX output was computed on these
    inputs."""
    h = hashlib.sha256()
    for leaf in jax.tree_util.tree_leaves(trees):
        a = np.asarray(leaf)
        h.update((a.astype(np.float64) if a.dtype.kind == "f" else a).tobytes())
        h.update(str(a.shape).encode())
    return h.hexdigest()


def stored(path, case, *inputs) -> dict:
    """The outputs stored under `case/` in the fixture at `path`, after
    checking that they were computed on `inputs`."""
    with np.load(path) as f:
        assert str(f[case + "/inputs"]) == inputs_digest(*inputs), \
            f"the stored JAX outputs of {case} were computed on other inputs: " \
            "rewrite the fixture"
        return {k.split("/", 1)[1]: f[k] for k in f.files if k.startswith(case + "/")}


def save(path, cases: dict):
    """Write {case: (inputs, outputs dict)} to the fixture at `path`."""
    out = {}
    for case, (inputs, outputs) in cases.items():
        out[case + "/inputs"] = np.asarray(inputs_digest(*inputs))
        out.update({f"{case}/{k}": np.asarray(v) for k, v in outputs.items()})
    np.savez_compressed(path, **out)
    return out
