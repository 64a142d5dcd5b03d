"""Headless deformed-mesh rendering of simulation states: the port of
`evosoro_tpu.viz.render`.

The capability analog of the reference's OpenGL sim view (reference:
VoxCad/VXS_SimGLView.cpp:1-857: each voxel drawn as a cube at its current
pose, coloured by its material's RGBA, with the deformable-mesh view mode),
rendered with matplotlib's 3D Poly3DCollection. The surface facets are the
corner-averaged deformed mesh of the facet drag (`envs.drag`), so what is
drawn is the surface the physics sees. The vertices are computed on the
device of the state's tensors, then moved to the host; matplotlib is
imported only by the functions that draw.
"""

from __future__ import annotations

import numpy as np
import torch

from evosoro_tpu_torch.envs.drag import build_mesh_drag


def material_colors(palette_materials):
    """id -> rgba from Material entries (reference palette colors:
    tools/read_write_voxelyze.py:175-344 / VX_Object.h CVXC_Material)."""
    colors = {0: (0, 0, 0, 0)}
    for m in palette_materials:
        colors[m.id] = tuple(m.rgba)
    return colors


def _deformed_vertices(pos, quat, scale, sys):
    """envs.drag's vertex update (corner-averaged poses) on the device of
    the mesh tables, as a host (V, 3) array."""
    from evosoro_tpu_torch.core import quaternion as q

    dev = sys.vert_vox.device
    posf = torch.as_tensor(pos, device=dev).reshape(-1, 3)
    quatf = torch.as_tensor(quat, device=dev).reshape(-1, 4)
    scalef = torch.as_tensor(scale, device=dev).reshape(-1)
    p = posf[sys.vert_vox]
    qv = quatf[sys.vert_vox]
    s = scalef[sys.vert_vox]
    off = 0.5 * s[..., None] * sys.vert_sign
    world = p + q.quat_rotate(qv, off)
    wsum = sys.vert_w.sum(1)
    vpos = (world * sys.vert_w[..., None]).sum(1) / torch.clamp(wsum, min=1.0)[..., None]
    return vpos.cpu().numpy()


def _pose(state_or_pose):
    if hasattr(state_or_pose, "pos"):
        return state_or_pose.pos, state_or_pose.quat, state_or_pose.scale
    return state_or_pose


def surface(body, state_or_pose, materials=None):
    """(vertices (V, 3), triangles (T, 3), owner voxels (T,), face colours
    (T, 4)) of the deformed surface that `render_state` draws, as host
    arrays: what it draws, without matplotlib."""
    pos, quat, scale = _pose(state_or_pose)
    sys = body.mesh_drag
    if sys is None:
        sys = build_mesh_drag(body.mat.cpu().numpy(), device=body.mat.device,
                              dtype=body.nom_pos.dtype)
    verts = _deformed_vertices(pos, quat, scale, sys)
    mask = sys.tri_mask.cpu().numpy()
    tri = sys.tri_verts.cpu().numpy()[mask]
    owners = sys.tri_owner.cpu().numpy()[mask]

    mats = body.mat.cpu().numpy().reshape(-1)[owners]
    if materials is None:
        from evosoro_tpu_torch.core.types import evosoro_default_palette

        materials = evosoro_default_palette()
    cmap = material_colors(materials)
    face_colors = np.array([cmap.get(int(m), (0.5, 0.5, 0.5, 1.0)) for m in mats])
    return verts, tri, owners, face_colors


def render_state(
    body,
    state_or_pose,
    path=None,
    materials=None,
    elev=18,
    azim=-60,
    dpi=110,
    ax=None,
    bounds=None,
):
    """Render one state (or a (pos, quat, scale) tuple) to `path` (PNG) or
    into an existing matplotlib 3D axis. Returns the axis."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    verts, tri, _, face_colors = surface(body, state_or_pose, materials)

    own_fig = ax is None
    if ax is None:
        fig = plt.figure(figsize=(6, 5))
        ax = fig.add_subplot(111, projection="3d")
    polys = verts[tri]  # (T, 3, 3)
    coll = Poly3DCollection(
        polys, facecolors=face_colors, edgecolors=(0, 0, 0, 0.15),
        linewidths=0.2,
    )
    ax.add_collection3d(coll)

    if bounds is None:
        lo = verts.min(axis=0)
        hi = verts.max(axis=0)
        c = 0.5 * (lo + hi)
        r = max(float((hi - lo).max()) * 0.6, 1e-6)
        bounds = (c - r, c + r)
    ax.set_xlim(bounds[0][0], bounds[1][0])
    ax.set_ylim(bounds[0][1], bounds[1][1])
    ax.set_zlim(max(0.0, bounds[0][2]), bounds[1][2])
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((1, 1, 1))
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")

    if path is not None and own_fig:
        ax.figure.savefig(path, dpi=dpi, bbox_inches="tight")
        plt.close(ax.figure)
    return ax


def save_animation(
    body,
    trajectory,
    path,
    materials=None,
    fps=12,
    elev=18,
    azim=-60,
    dpi=90,
):
    """Write an animated GIF of a recorded Trajectory (viz.trajectory).

    Fixed camera and bounds over the whole clip, so locomotion reads as
    translation (what the reference's VoxCad playback shows)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    pos = torch.as_tensor(trajectory.pos).cpu().numpy()
    F = pos.shape[0]
    lo = pos.reshape(F, -1, 3).min(axis=(0, 1)) - 0.01
    hi = pos.reshape(F, -1, 3).max(axis=(0, 1)) + 0.01
    c = 0.5 * (lo + hi)
    r = max(float((hi - lo).max()) * 0.6, 1e-6)
    bounds = (c - r, c + r)

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")

    def draw(f):
        ax.cla()
        render_state(
            body,
            (trajectory.pos[f], trajectory.quat[f], trajectory.scale[f]),
            materials=materials, elev=elev, azim=azim, ax=ax, bounds=bounds,
        )
        ax.set_title(f"t = {float(trajectory.time[f]):.3f} s")

    anim = FuncAnimation(fig, draw, frames=F, interval=1000 / fps)
    anim.save(path, writer=PillowWriter(fps=fps), dpi=dpi)
    plt.close(fig)
    return path
