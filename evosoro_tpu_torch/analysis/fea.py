"""Static linear FEA on the voxel lattice: the port of
`evosoro_tpu.analysis.fea`, the reference's VX_FEA capability.

The reference's CVX_FEA (reference: VX_FEA.{h,cpp}) assembles a sparse
global stiffness matrix from the lattice's frame elements and hands it to a
direct solver. Here, as in the JAX package, the capability is matrix-free:
the eager step's beam-bond force function (core/step._bond_axis_forces, the
Euler-Bernoulli frame element of VXS_BondInternal.cpp) IS the stiffness
operator. Its exact linearization at the rest state gives K·u without
forming K, and conjugate gradients solve K·u = f as a chain of those
matvecs.

The frame element is the one the dynamics integrate, so a static solution
is the dynamics' equilibrium (the analytic cantilever check of
VX_Benchmark.cpp:34-82 holds it in the tests). Everything runs on the
device of the body's tensors, in their dtype.
"""

from __future__ import annotations

import torch

from evosoro_tpu_torch.core import quaternion as q
from evosoro_tpu_torch.core.constants import DEFAULT_PRECISION
from evosoro_tpu_torch.core.rollout import init_state
from evosoro_tpu_torch.core.step import _bond_axis_forces, _from_nbrv
from evosoro_tpu_torch.core.types import EnvParams, SimParams, VoxelBody


def _elastic_loads(body: VoxelBody, u, w):
    """Internal elastic force and moment on every voxel for a displacement
    field u (X, Y, Z, 3) and a rotation-vector field w (X, Y, Z, 3).

    Positions are nom + u and orientations exp(w); a zero dt turns the bond
    damping off, and no gravity, floor or external force enters: this is
    the pure frame-element response."""
    state = init_state(body).replace(
        pos=body.nom_pos + u, quat=q.quat_from_rotation_vector(w))
    sim = SimParams()
    env = EnvParams(gravity_enabled=False, floor_enabled=False, temp_enabled=False)
    dt = torch.zeros((), dtype=u.dtype, device=u.device)
    L = torch.tensor(body.nominal_size, dtype=u.dtype, device=u.device)
    force = torch.zeros_like(u)
    moment = torch.zeros_like(w)
    for d in range(3):
        if not bool(body.bond_mask[d].any()):
            continue  # no bond along d: its masked loads are zeros
        b = _bond_axis_forces(d, state, body, sim, env, dt, L, DEFAULT_PRECISION)
        force = force + b["f1"] + _from_nbrv(b["f2"], d)
        moment = moment - b["m1"] - _from_nbrv(b["m2"], d)
    return force, moment


def linear_operator(body: VoxelBody):
    """K(u, w) -> (f, m): the exact linearization of the beam-bond force
    field at rest (the global stiffness operator, applied matrix-free). K·x
    is the restoring load, so the equilibrium equation reads K·x = f_ext.

    The JAX package takes `jax.jvp` of the loads at every product. Here the
    loads' vjp at rest is built once as a graph that is linear in its
    cotangent c, g(c) = J'c, and each product is J·v = d(g(c)·v)/dc, one
    backward pass through that graph: the jvp's values (the tests hold them
    to JAX's jvp at rtol 1e-10) at a third of `torch.func.jvp`'s cost on
    the CPU, where forward mode pays for its zero tangents op by op."""
    with torch.enable_grad():
        u0 = torch.zeros_like(body.nom_pos, requires_grad=True)
        w0 = torch.zeros_like(body.nom_pos, requires_grad=True)
        f0, m0 = _elastic_loads(body, u0, w0)
        cf = torch.zeros_like(f0, requires_grad=True)
        cm = torch.zeros_like(m0, requires_grad=True)
        gu, gw = _grad((f0, m0), (u0, w0), (cf, cm), create_graph=True)

    def matvec(u, w):
        df, dm = _grad((gu, gw), (cf, cm), (u, w), retain_graph=True)
        return -df, -dm

    return matvec


def _grad(outputs, inputs, grad_outputs, **kw):
    """`torch.autograd.grad` with zeros where an input does not reach the
    outputs (a body without bonds has no elastic loads)."""
    live = [(o, g) for o, g in zip(outputs, grad_outputs) if o.requires_grad]
    if not live:
        return tuple(torch.zeros_like(i) for i in inputs)
    got = torch.autograd.grad([o for o, _ in live], inputs, [g for _, g in live],
                              allow_unused=True, **kw)
    return tuple(torch.zeros_like(i) if g is None else g for g, i in zip(got, inputs))


def _dot(a, b):
    """<a, b> summed over the fields of two tuples of tensors."""
    return sum((x * y).sum() for x, y in zip(a, b))


def _cg(A, b, tol: float, maxiter: int):
    """Conjugate gradients on a tuple of fields, as
    `jax.scipy.sparse.linalg.cg(A, b, tol=tol, maxiter=maxiter)` runs with
    no preconditioner: x0 = 0, so r = b; it stops once <r, r> <= tol²·<b, b>
    or after `maxiter` iterations. Returns (x, iterations)."""
    x = tuple(torch.zeros_like(t) for t in b)
    r, p = b, b
    gamma = _dot(r, r)
    atol2 = tol * tol * _dot(b, b)
    k = 0
    while k < maxiter and bool(gamma > atol2):
        Ap = A(p)
        alpha = gamma / _dot(p, Ap)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri - alpha * api for ri, api in zip(r, Ap))
        gamma_new = _dot(r, r)
        beta = gamma_new / gamma
        p = tuple(ri + beta * pi for ri, pi in zip(r, p))
        gamma = gamma_new
        k += 1
    return x, k


def _masked(matvec, free):
    """The operator restricted to the free degrees of freedom."""
    def A(xs):
        u, w = xs
        fu, fw = matvec(u * free, w * free)
        return fu * free, fw * free

    return A


def fea_solve(
    body: VoxelBody,
    ext_force=None,
    ext_moment=None,
    fixed_mask=None,
    tol: float = 1e-9,
    maxiter: int | None = None,
):
    """Solve the static problem K·x = f for voxel displacements/rotations.

    `ext_force`/`ext_moment`: (X,Y,Z,3) applied loads [N]/[N·m].
    `fixed_mask`: (X,Y,Z) bool of fully-clamped voxels (defaults to
    body.dof_fixed != 0 — region BCs from the VXA).

    Returns dict(displacement=(X,Y,Z,3), rotation=(X,Y,Z,3),
    residual=scalar, iterations=int), on the body's device. Matrix-free CG
    over the 6-DOF-per-voxel field; fixed and empty voxels are projected out
    of the Krylov space. `iterations` (the CG's count) is the port's
    addition to the JAX package's dict.
    """
    X, Y, Z = body.occ.shape
    dtype, dev = body.nom_pos.dtype, body.nom_pos.device

    def load(a):
        if a is None:
            return torch.zeros((X, Y, Z, 3), dtype=dtype, device=dev)
        return torch.as_tensor(a, device=dev).to(dtype)

    f, m = load(ext_force), load(ext_moment)
    if fixed_mask is None:
        fixed_mask = body.dof_fixed != 0
    fixed_mask = torch.as_tensor(fixed_mask, device=dev)
    free = (body.occ & ~fixed_mask)[..., None]

    A = _masked(linear_operator(body), free)
    b = (f * free, m * free)
    if maxiter is None:
        maxiter = 20 * X * Y * Z
    sol, iters = _cg(A, b, tol, maxiter)
    u, w = sol
    ru, rw = A(sol)
    res = torch.sqrt(((ru - b[0]) ** 2).sum() + ((rw - b[1]) ** 2).sum())
    return dict(displacement=u * free, rotation=w * free, residual=res,
                iterations=iters)
