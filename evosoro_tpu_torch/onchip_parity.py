"""K1 against the eager step on the card, scenario by scenario.

The port's twin of the JAX package's `tools/onchip_parity.py` (its record:
ONCHIP_PARITY.json, taken on a TPU). The same 12 feature scenarios, built
by name with the same constructors and seeds, each run for STEPS steps on
BATCH copies of its robot through K1 (`fused_rollout`) and through the
eager reference: a `sim_step` loop, or `core.rollout.rollout` where the
scenario's features live in the rollout (`use_rollout`). Each record holds
the largest |Δpos| and |Δlinmom| between the two, the span of the
positions and whether K1 diverged, beside the card's name and power limit.

    python -m evosoro_tpu_torch.onchip_parity [--out PATH] [--check PATH]
        [--steps N] [--device cpu]

`--out PATH` writes the record as JSON (ONCHIP_PARITY_TORCH.json at the
repository root is one from an H100). `--check PATH` holds this run to a
record with the JAX tool's rule and exits 1 on a failure: a scenario fails
past CHECK_MARGIN times its recorded drift (with an absolute floor of
CHECK_FLOOR) or when it diverged; a scenario the record lacks has no bound
yet. `device` defaults to the card (`--device cpu` runs the plain
versions).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

STEPS = 100
BATCH = 8
# chaotic-saturation jitter: the saturated drift level itself moves with
# any legal reordering, so a run is held to bound x margin with an absolute
# floor of one float32 ulp at position scale (the JAX tool's rule)
CHECK_MARGIN = 3.0
CHECK_FLOOR = 1e-8


def _palette(materials=None, device=None):
    from evosoro_tpu_torch.core.materials import palette_from_list
    from evosoro_tpu_torch.core.types import evosoro_default_palette

    return palette_from_list(materials or evosoro_default_palette(), device=device)


def _scenario_default(rng, device):
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body

    s = rng.integers(0, 5, size=(5, 5, 5)).astype(np.int32)
    s[2, 2, 0] = 3
    body = build_body(s, _palette(device=device),
                      phase_offset=rng.uniform(-1, 1, size=s.shape), device=device)
    return body, SimParams(init_cm_time=0.0), EnvParams(), {}


def _scenario_collision(rng, device):
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body, init_state
    from evosoro_tpu_torch.core.collision import attach_collision_system

    s = np.zeros((4, 1, 1), dtype=np.int32)
    s[:2, 0, 0] = 1
    s[3, 0, 0] = 1
    body = attach_collision_system(
        build_body(s, _palette(device=device), lattice_dim=0.01, device=device))
    sim = SimParams(self_collisions_enabled=True)
    env = EnvParams(gravity_enabled=False, floor_enabled=False, temp_enabled=False)
    st = init_state(body)
    linmom = st.linmom.clone()
    linmom[3, 0, 0, 0] = -2.0 * float(body.mass[3, 0, 0])
    return body, sim, env, {"state": st.replace(linmom=linmom)}


def _scenario_volume(rng, device):
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body, init_state

    s = rng.integers(1, 5, size=(4, 4, 4)).astype(np.int32)
    body = build_body(s, _palette(device=device),
                      phase_offset=rng.uniform(-1, 1, size=s.shape), device=device)
    sim = SimParams(volume_effects_enabled=True, init_cm_time=0.0)
    env = EnvParams(temp_amplitude=10.0)
    return body, sim, env, {"state": init_state(body, volume_effects=True)}


def _scenario_fluid(rng, device):
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body

    s = rng.integers(0, 5, size=(4, 4, 4)).astype(np.int32)
    s[:, :, 0] = 3
    body = build_body(s, _palette(device=device),
                      phase_offset=rng.uniform(-1, 1, size=s.shape), device=device)
    sim = SimParams(init_cm_time=0.0)
    env = EnvParams(fluid_environment=True, gravity_enabled=False,
                    floor_enabled=False, aggregate_drag_coefficient=375.0)
    return body, sim, env, {}


def _scenario_fluid_mesh(rng, device):
    # the facet drag on the deformed mesh, with the corner shell K1 needs
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body
    from evosoro_tpu_torch.envs.drag import attach_mesh_drag

    s = np.zeros((5, 5, 5), dtype=np.int32)
    s[:4, :4, :4] = rng.integers(0, 5, size=(4, 4, 4))
    s[:4, :4, 0] = 3
    body = attach_mesh_drag(
        build_body(s, _palette(device=device),
                   phase_offset=rng.uniform(-1, 1, size=s.shape), device=device))
    sim = SimParams(init_cm_time=0.0)
    env = EnvParams(fluid_environment=True, gravity_enabled=False,
                    floor_enabled=False, aggregate_drag_coefficient=375.0)
    return body, sim, env, {}


def _scenario_bilinear(rng, device):
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body
    from evosoro_tpu_torch.core.types import MDL_BILINEAR, Material, evosoro_default_palette

    soft = [
        Material(m.id, m.name, m.elastic_mod, cte=m.cte,
                 mat_model=MDL_BILINEAR, plastic_mod=m.elastic_mod * 0.01,
                 yield_stress=m.elastic_mod * 1e-4)
        for m in evosoro_default_palette()
    ]
    s = rng.integers(1, 5, size=(4, 4, 4)).astype(np.int32)
    body = build_body(s, _palette(soft, device),
                      phase_offset=rng.uniform(-1, 1, size=s.shape), device=device)
    return body, SimParams(init_cm_time=0.0), EnvParams(), {}


def _scenario_equilibrium_maxvel(rng, device):
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body

    s = rng.integers(1, 5, size=(4, 4, 4)).astype(np.int32)
    body = build_body(s, _palette(device=device),
                      phase_offset=rng.uniform(-1, 1, size=s.shape), device=device)
    sim = SimParams(init_cm_time=0.0, equilibrium_mode=True,
                    max_velocity_enabled=True, max_vox_vel_limit=1e-4)
    return body, sim, EnvParams(), {}


def _scenario_plasticity(rng, device):
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body

    s = rng.integers(1, 5, size=(4, 4, 4)).astype(np.int32)
    body = build_body(s, _palette(device=device),
                      phase_offset=rng.uniform(-1, 1, size=s.shape), device=device)
    return body, SimParams(init_cm_time=0.0, plasticity_enabled=True), EnvParams(), {}


def _scenario_mdl_data(rng, device):
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body
    from evosoro_tpu_torch.core.types import MDL_DATA, Material

    E = 5e6
    mats = [
        Material(1, "d1", mat_model=MDL_DATA, cte=0.02,
                 ss_strain=(0.0, 0.001, 0.05, 0.5),
                 ss_stress=(0.0, E * 0.001, E * 0.0015, E * 0.0017)),
        Material(2, "d2", mat_model=MDL_DATA, cte=-0.02,
                 ss_strain=(0.0, 0.002, 0.1),
                 ss_stress=(0.0, E * 0.004, E * 0.006)),
    ]
    s = rng.integers(1, 3, size=(4, 4, 4)).astype(np.int32)
    body = build_body(s, _palette(mats, device),
                      phase_offset=rng.uniform(-1, 1, size=s.shape), device=device)
    return body, SimParams(init_cm_time=0.0), EnvParams(temp_amplitude=25.0), {}


def _scenario_bc(rng, device):
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body
    from evosoro_tpu_torch.core.types import DOF_ALL

    n = 4
    s = np.ones((n, 2, 2), dtype=np.int32)
    dof = np.zeros((n, 2, 2), dtype=np.int32)
    dof[0] = DOF_ALL
    extf = np.zeros((n, 2, 2, 3))
    extf[-1, :, :, 2] = -0.05
    body = build_body(s, _palette(device=device), lattice_dim=0.01, dof_fixed=dof,
                      external_force=extf, device=device)
    return body, SimParams(), EnvParams(temp_enabled=False), {}


def _scenario_features(rng, device):
    """Needle, fall-over latch, NormDistByVol and speed windows at once;
    the latch and the windows live in the rollout, so the reference is
    `core.rollout.rollout`."""
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body

    s = rng.integers(1, 5, size=(4, 4, 4)).astype(np.int32)
    s[2, 2, 3] = 7  # needle
    s[0, 0, 0] = 6  # a foot
    body = build_body(s, _palette(device=device),
                      phase_offset=rng.uniform(-1, 1, size=s.shape), device=device)
    sim = SimParams(init_cm_time=0.0)
    env = EnvParams(needle_in_haystack=True, falling_prohibited=True,
                    norm_dist_by_vol=True, time_between_traces=0.0005,
                    num_trace_steps_in_window=4)
    return body, sim, env, {"use_rollout": True}


def _scenario_ballistic(rng, device):
    """Ballistic development: the dynamic development state rebased in K1."""
    from evosoro_tpu_torch.core import EnvParams, SimParams, build_body, init_state

    s = np.zeros((3, 3, 2), dtype=np.int32)
    s[:, :, 0] = 3
    s[:, :, 1] = 1
    L = 0.01
    body = build_body(
        s, _palette(device=device), lattice_dim=L,
        phase_offset=rng.uniform(-1, 1, size=s.shape) * (s > 0),
        initial_voxel_size=np.full(s.shape, L),
        final_voxel_size=np.full(s.shape, 1.4 * L),
        growth_time=np.full(s.shape, 0.02),
        start_growth_time=np.full(s.shape, 0.002), device=device,
    )
    sim = SimParams(init_cm_time=0.001)
    env = EnvParams(growth_amplitude=0.5, num_trace_steps_in_window=4,
                    time_between_traces=0.001, norm_dist_by_vol=True,
                    ballistic_slowdown_fact=1.0, max_slowdown_permitted=-0.5,
                    min_growth_time=0.0)
    st = init_state(body, ballistic_devo=True)
    return body, sim, env, {"state": st, "use_rollout": True}


SCENARIOS = {
    "default": _scenario_default,
    "collision": _scenario_collision,
    "volume_effects": _scenario_volume,
    "fluid_drag": _scenario_fluid,
    "fluid_mesh": _scenario_fluid_mesh,
    "bilinear": _scenario_bilinear,
    "equilibrium_maxvel": _scenario_equilibrium_maxvel,
    "plasticity": _scenario_plasticity,
    "mdl_data": _scenario_mdl_data,
    "bc_regions": _scenario_bc,
    "fitness_features": _scenario_features,
    "ballistic_devo": _scenario_ballistic,
}


def scenario(name: str, device=None):
    """(body, sim, env, extras) of a scenario, from its seed (3)."""
    from evosoro_tpu_torch.device import resolve_device

    return SCENARIOS[name](np.random.default_rng(3), resolve_device(device))


def run_scenario(name: str, steps: int = STEPS, device=None) -> dict:
    """One scenario's record: K1 against the eager reference over `steps`
    steps on BATCH copies of its robot."""
    from evosoro_tpu_torch.core import calc_max_dt, init_state, rollout, sim_step
    from evosoro_tpu_torch.ops.fused_rollout import fused_rollout, refusal
    from evosoro_tpu_torch.parallel.mesh import tree_map

    body, sim, env, kw = scenario(name, device)
    why = refusal(body, sim, env)
    assert why is None, (name, why)
    dt = calc_max_dt(body) * sim.dt_frac
    state = kw.get("state")
    if state is None:
        state = init_state(body)
    batched = tree_map(lambda x: x.expand((BATCH,) + x.shape).clone(), state)
    if kw.get("use_rollout"):
        # the fall-over latch, the trace windows and the ballistic rebase's
        # windows live in the rollout's step function
        ref = rollout(body, sim, env, num_steps=steps, dt=dt, state=batched).final_state
    else:
        ref = batched
        for _ in range(steps):
            ref = sim_step(ref, body, sim, env, dt)
    fused, stats = fused_rollout(batched, body, sim, env, num_steps=steps, dt=dt)
    return {
        "max_abs_pos_diff_m": float((fused.pos - ref.pos).abs().max()),
        "max_abs_linmom_diff": float((fused.linmom - ref.linmom).abs().max()),
        "pos_span_m": float(ref.pos.abs().max()),
        "diverged": bool(stats.diverged.any()),
    }


def measure(steps: int = STEPS, device=None) -> dict:
    """Every scenario's record on BATCH copies of its robot, with the card's
    name and power limit on the card."""
    from evosoro_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    out = {"metric": "k1_vs_eager_on_card", "steps": steps, "batch": BATCH,
           "device": str(dev), "scenarios": {}}
    if dev.type == "cuda":
        from evosoro_tpu_torch.bench import card_info

        out["card"] = card_info()
    for name in SCENARIOS:
        out["scenarios"][name] = run_scenario(name, steps, dev)
        print(name, out["scenarios"][name], flush=True)
    return out


def check(record: dict, committed: dict) -> list:
    """The failures of `record` against a `committed` record, by the JAX
    tool's rule: past max(committed drift x CHECK_MARGIN, CHECK_FLOOR), or
    diverged. A scenario `committed` lacks has no bound yet."""
    failures = []
    for name, rec in record["scenarios"].items():
        if rec["diverged"]:
            failures.append(f"{name}: diverged")
        if name not in committed["scenarios"]:
            continue
        was = committed["scenarios"][name]["max_abs_pos_diff_m"]
        bound = max(was * CHECK_MARGIN, CHECK_FLOOR)
        if rec["max_abs_pos_diff_m"] > bound:
            failures.append(f"{name}: {rec['max_abs_pos_diff_m']:.3e} > bound "
                            f"{bound:.3e} (recorded {was:.3e})")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the record here (JSON)")
    ap.add_argument("--check", default=None,
                    help="hold this run to the record at this path; exit 1 on a failure")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    out = measure(args.steps, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print("written", args.out)
    if args.check:
        with open(args.check) as f:
            failures = check(out, json.load(f))
        if failures:
            print("K1 PARITY CHECK FAILED:\n  " + "\n  ".join(failures))
            raise SystemExit(1)
        print(f"K1 parity check OK ({len(out['scenarios'])} scenarios within the "
              f"recorded bound x {CHECK_MARGIN})")
    return out


if __name__ == "__main__":
    main()
