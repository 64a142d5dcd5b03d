"""Interactive physics sandbox, the headless-interactive analog of VoxCad's
live simulation view: the port of `evosoro_tpu.viz.sandbox`.

The reference's GUI sandbox (reference:
_voxcad/VoxCad/QVX_Interfaces.h:125 QVX_Sim + VXS_SimGLView.cpp) lets a user
load a design, run/pause/step the physics, poke voxels with forces and watch
the deformed mesh. This module gives the same interaction two ways:

- `InteractiveSandbox`: a session object. Load a VXA or a built body,
  `step`/`run_for`/`reset`, apply transient pokes (`apply_force`), query
  live observables (time, CoM, kinetic energy, per-voxel state) and
  `render` frames or `record_gif` clips of the deformed surface mesh.
- a terminal REPL (`python -m evosoro_tpu_torch.viz.sandbox design.vxa
  [--device cpu]`) driving that object with one-letter commands.

The physics step is the eager `sim_step` (the whole feature surface), as
the JAX package's sandbox runs its general jnp step: a session advances a
step at a time, with the poke added to the body's external force. The
session runs on the device of the body's tensors: `from_vxa` and the REPL
build the body on the card unless asked for the CPU.

`record_gif` stacks its frames and their times into a `Trajectory` for
`save_animation`; the JAX package's passes a list of tuples, which its
`save_animation` cannot read (ROADMAP section C).
"""

from __future__ import annotations

import numpy as np
import torch

from evosoro_tpu_torch.core.materials import calc_max_dt
from evosoro_tpu_torch.core.rollout import center_of_mass, init_state
from evosoro_tpu_torch.core.step import sim_step


class InteractiveSandbox:
    """Load / run / poke / watch one design interactively."""

    def __init__(self, body, sim, env, dt=None, dtype=None):
        self.body = body
        self.sim = sim
        self.env = env
        self.dt = float(dt) if dt is not None else float(
            calc_max_dt(body, sim.volume_effects_enabled) * sim.dt_frac)
        self._ballistic = bool(
            getattr(env, "num_trace_steps_in_window", 0) > 0
            and body.using_final_voxel_size)
        self._dtype = dtype
        self.state = self._rest_state()
        self.steps_done = 0
        self._poke = np.zeros(tuple(body.occ.shape) + (3,), dtype=np.float64)
        self._poke_steps = 0
        self._frames = []
        self._base_extf = body.external_force

    def _rest_state(self):
        return init_state(self.body, dtype=self._dtype,
                          volume_effects=self.sim.volume_effects_enabled,
                          ballistic_devo=self._ballistic)

    def _step(self, state, extra_force):
        b = self.body.replace(external_force=self._base_extf + extra_force)
        return sim_step(state, b, self.sim, self.env, self.dt)

    @classmethod
    def from_vxa(cls, path, dtype=None, device=None):
        """Open a .vxa exactly like dropping it on the reference GUI, on
        `device`: the card when none is named (without one this raises),
        `device="cpu"` for the CPU."""
        from evosoro_tpu_torch.device import resolve_device
        from evosoro_tpu_torch.io.vxa import load_vxa

        doc = load_vxa(path)
        body = doc.build_body(dtype=dtype, device=resolve_device(device))
        return cls(body, doc.sim, doc.env, dtype=dtype)

    # ---- time control -------------------------------------------------
    def step(self, n: int = 1):
        """Advance `n` physics steps (active pokes decay with their
        remaining duration)."""
        like = self.body.nom_pos
        zero = torch.zeros(self._poke.shape, dtype=like.dtype, device=like.device)
        for _ in range(int(n)):
            f = torch.as_tensor(self._poke, device=like.device).to(like.dtype) \
                if self._poke_steps > 0 else zero
            self.state = self._step(self.state, f)
            if self._poke_steps > 0:
                self._poke_steps -= 1
                if self._poke_steps == 0:
                    self._poke[:] = 0.0
            self.steps_done += 1
        return self

    def run_for(self, seconds: float):
        """Run sim-time `seconds` of physics."""
        return self.step(int(np.ceil(seconds / self.dt)))

    def reset(self):
        """Back to the rest state (reference: ResetSim)."""
        self.state = self._rest_state()
        self.steps_done = 0
        self._poke[:] = 0.0
        self._poke_steps = 0
        return self

    # ---- interaction --------------------------------------------------
    def apply_force(self, voxel, force, duration_steps: int = 50):
        """Poke: apply `force` (N, 3-vector) at lattice coordinate `voxel`
        for the next `duration_steps` steps — the mouse-drag analog of the
        reference sandbox."""
        x, y, z = (int(v) for v in voxel)
        if not bool(self.body.occ[x, y, z]):
            raise ValueError(f"no voxel at {(x, y, z)}")
        self._poke[x, y, z] += np.asarray(force, dtype=np.float64)
        self._poke_steps = max(self._poke_steps, int(duration_steps))
        return self

    def clear_forces(self):
        self._poke[:] = 0.0
        self._poke_steps = 0
        return self

    # ---- observables --------------------------------------------------
    @property
    def time(self) -> float:
        return float(self.state.time)

    def center_of_mass(self):
        return center_of_mass(self.state, self.body).cpu().numpy()

    def kinetic_energy(self) -> float:
        v = self.state.linmom * self.body.mass_inv[..., None]
        return float((0.5 * (self.state.linmom * v)).sum())

    def status(self) -> str:
        cm = self.center_of_mass()
        return (f"t={self.time:.6f}s steps={self.steps_done} "
                f"cm=({cm[0]:.5f},{cm[1]:.5f},{cm[2]:.5f}) "
                f"ke={self.kinetic_energy():.3e}J "
                f"poke={'on' if self._poke_steps else 'off'}")

    # ---- rendering ----------------------------------------------------
    def render(self, path=None, **kw):
        """Render the current deformed surface mesh (PNG when `path`)."""
        from evosoro_tpu_torch.viz.render import render_state

        return render_state(self.body, self.state, path=path, **kw)

    def _pose(self):
        return (self.state.pos.cpu(), self.state.quat.cpu(), self.state.scale.cpu(),
                self.state.time.cpu())

    def snapshot(self):
        """Store the current pose for `record_gif`."""
        self._frames.append(self._pose())
        return self

    def record_gif(self, path, every=None, steps=None, fps=20):
        """Animate either the stored `snapshot`s, or run `steps` more
        physics capturing a frame every `every` steps."""
        from evosoro_tpu_torch.viz.render import save_animation
        from evosoro_tpu_torch.viz.trajectory import Trajectory

        frames = list(self._frames)
        if steps:
            every = every or max(1, steps // 50)
            for i in range(steps):
                self.step(1)
                if i % every == 0:
                    frames.append(self._pose())
        pos, quat, scale, time = (torch.stack(list(c)) for c in zip(*frames))
        save_animation(self.body, Trajectory(pos=pos, quat=quat, scale=scale, time=time,
                                             final_state=self.state), path, fps=fps)
        self._frames = []
        return path


_HELP = """commands:
  s [n]            step n physics steps (default 1)
  t <seconds>      run that much sim time
  p x y z fx fy fz [steps]   poke voxel (x,y,z) with force (N)
  c                clear active pokes
  r <out.png>      render current pose
  g <out.gif> <steps> [every]  run + record a clip
  i                print status (time / CoM / KE)
  z                reset to rest state
  q                quit
"""


def repl(sandbox: InteractiveSandbox, stdin=None, stdout=None):
    """Terminal REPL over an InteractiveSandbox (scriptable: pass file-like
    stdin/stdout for tests)."""
    import sys as _sys

    stdin = stdin or _sys.stdin
    stdout = stdout or _sys.stdout

    def out(msg):
        stdout.write(msg + "\n")
        stdout.flush()

    out("evosoro_tpu_torch interactive sandbox — 'q' quits, '?' for help")
    out(sandbox.status())
    for line in stdin:
        toks = line.split()
        if not toks:
            continue
        cmd, args = toks[0], toks[1:]
        try:
            if cmd == "q":
                break
            elif cmd == "?":
                out(_HELP)
            elif cmd == "s":
                sandbox.step(int(args[0]) if args else 1)
                out(sandbox.status())
            elif cmd == "t":
                sandbox.run_for(float(args[0]))
                out(sandbox.status())
            elif cmd == "p":
                x, y, z, fx, fy, fz = (float(v) for v in args[:6])
                dur = int(args[6]) if len(args) > 6 else 50
                sandbox.apply_force((x, y, z), (fx, fy, fz), dur)
                out(f"poking ({int(x)},{int(y)},{int(z)}) with "
                    f"({fx},{fy},{fz}) N for {dur} steps")
            elif cmd == "c":
                sandbox.clear_forces()
                out("pokes cleared")
            elif cmd == "r":
                sandbox.render(path=args[0])
                out(f"rendered {args[0]}")
            elif cmd == "g":
                sandbox.record_gif(args[0], steps=int(args[1]),
                                   every=int(args[2]) if len(args) > 2
                                   else None)
                out(f"recorded {args[0]}")
            elif cmd == "i":
                out(sandbox.status())
            elif cmd == "z":
                sandbox.reset()
                out("reset. " + sandbox.status())
            else:
                out(f"unknown command {cmd!r} — '?' for help")
        except Exception as e:  # keep the session alive on bad input
            out(f"error: {e}")
    return sandbox


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Interactive soft-body sandbox (VoxCad physics-view "
                    "analog)")
    ap.add_argument("vxa", help=".vxa design file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    repl(InteractiveSandbox.from_vxa(args.vxa, device=args.device))


if __name__ == "__main__":
    main()
