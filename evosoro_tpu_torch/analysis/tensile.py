"""Tensile-test harness, the QVX_TensileTest capability, headless: the port
of `evosoro_tpu.analysis.tensile`.

The reference GUI sweeps prescribed displacement steps on a specimen and
records the reaction force into a stress-strain curve (reference:
VoxCad/QVX_TensileTest.{h,cpp}). Here each displacement step is a static
solve: clamp one face, prescribe displacement on the opposite face, solve
the free DOFs with matrix-free CG (analysis/fea.py), and read the reaction
force off the prescribed face from the same beam-bond operator.
"""

from __future__ import annotations

import torch

from evosoro_tpu_torch.analysis.fea import _cg, _elastic_loads, _masked, linear_operator
from evosoro_tpu_torch.core.types import VoxelBody


def tensile_test(body: VoxelBody, axis: int = 0, strains=None,
                 tol: float = 1e-10, maxiter: int | None = None):
    """Displacement-controlled tension along `axis`.

    The -axis face is clamped; the +axis face is displaced by
    strain · specimen_length per sample. Returns dict with tensors
    `strain`, `force` (reaction on the pulled face, N), `stress`
    (force / undeformed cross-section area, Pa) and `stiffness`
    (dF/dδ of the first sample, N/m), on the body's device, and
    `iterations`, each sample's CG count (the port's addition).

    The JAX package maps one solve over the strains with `jax.vmap`, under
    which each lane's loop stops where its own would; this solves them one
    after another, which gives the same result.
    """
    occ = body.occ
    X, Y, Z = occ.shape
    dtype, dev = body.nom_pos.dtype, body.nom_pos.device
    if strains is None:
        strains = torch.linspace(0.0, 0.02, 5, dtype=dtype)[1:]
    strains = torch.as_tensor(strains, device=dev).to(dtype)

    coords = torch.meshgrid(*(torch.arange(n, device=dev) for n in (X, Y, Z)),
                            indexing="ij")[axis]
    clamp = occ & (coords == coords.min())
    pull = occ & (coords == coords.max())

    L_total = (int(occ.shape[axis]) - 1) * body.nominal_size
    # cross-section: occupied voxels on the pulled face x voxel area
    area = pull.sum().to(dtype) * body.nominal_size ** 2

    matvec = linear_operator(body)
    free = (occ & ~clamp & ~pull)[..., None]
    A = _masked(matvec, free)
    if maxiter is None:
        maxiter = 20 * X * Y * Z

    forces, iterations = [], []
    for strain in strains:
        u_presc = torch.zeros((X, Y, Z, 3), dtype=dtype, device=dev)
        u_presc[..., axis] = torch.where(pull, strain * L_total, 0.0)
        w_zero = torch.zeros_like(u_presc)

        # load on the free DOFs induced by the prescribed displacements
        fb, mb = matvec(u_presc, w_zero)
        (su, sw), iters = _cg(A, (-fb * free, -mb * free), tol, maxiter)
        u = su * free + u_presc
        w = sw * free
        # reaction: the elastic load the specimen exerts on the pulled face
        f_int, _ = _elastic_loads(body, u, w)
        forces.append(-torch.where(pull, f_int[..., axis], 0.0).sum())
        iterations.append(iters)

    forces = torch.stack(forces)
    stress = forces / area
    stiffness = forces[0] / (strains[0] * L_total)
    return dict(strain=strains, force=forces, stress=stress,
                stiffness=stiffness, iterations=iterations)
