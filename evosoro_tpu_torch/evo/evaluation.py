"""In-process batched evaluation of a population on one device.

The port of `evosoro_tpu.evo.evaluation`: the reference's
process-per-individual bridge (tools/evaluation.py:18-219, one `voxelyze`
subprocess per robot) becomes one fused-rollout launch per dt bucket of a
generation. On a CUDA device that launch is the K1 kernel
(`ops.fused_rollout.fused_call`); on the CPU it is K1's plain version.
Divergence masks replace crash recovery; the md5 dedup cache and the
objective assignment are kept (evaluation.py:72-81, 160-177).

Fluid environments run the facet drag on the deformed surface mesh by
default (`Env(drag_model="mesh")`: the grid gains the one-cell corner shell
the kernel's stencil needs) or the voxel-face model
(`drag_model="voxel_face"`); devo genomes go through
`devo_params_from_vxa` into the kernel's development ramps. The fitness
features the environment switches on (NormDistByVol, the fall-over latch,
needle-in-haystack, speed windows, with ballistic development when a final
size is evolved under them, environmental sources) run inside the same
launch, and their result tags map onto `packed_metrics`. A custom palette
(`Env(materials=[...])`) with bilinear or MDL_DATA materials runs K1's
nonlinear stress, each individual's MDL_DATA tables streamed beside its
body; equilibrium mode takes its damping override. A `Sim` whose
`to_sim_params` turns volume effects on runs K1's volume instance, each
robot carrying its coupling carry and its own recomputed dt; the step
counts are padded by 15 % and a launch is made again, at most twice and
1.5 times as long, while a live robot ends short of the stop time (the JAX
package's rule).

Not ported yet: the jnp-scan fallback evaluator (`make_batched_evaluator`)
and the tags only it fills, the multi-device sharding.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from evosoro_tpu_torch.core.materials import (
    build_body,
    calc_max_dt,
    devo_params_from_vxa,
    palette_from_list,
)
from evosoro_tpu_torch.core.rollout import init_state, relaunch_until_stop
from evosoro_tpu_torch.core.types import evosoro_default_palette
from evosoro_tpu_torch.device import resolve_device
from evosoro_tpu_torch.ops import fused_rollout as fr

# phenotype-map tags -> build_body kwargs (reference: VX_Object.h:183-258)
_TAG_TO_FIELD = {
    "<Data>": "structure",
    "<PhaseOffset>": "phase_offset",
    "<FinalPhaseOffset>": "final_phase_offset",
    "<TempAmpDamp>": "temp_amp_damp",
    "<FinalTempAmpDamp>": "final_temp_amp_damp",
    "<InitialVoxelSize>": "initial_voxel_size",
    "<FinalVoxelSize>": "final_voxel_size",
    "<GrowthTime>": "growth_time",
    "<StartGrowthTime>": "start_growth_time",
    "<Stiffness>": "stiffness",
}

# result-XML tags -> packed_metrics keys (reference: VX_SimGA.cpp:140-203).
# The JAX package's other eight tags (<FinalDist>, <AnteriorDist>,
# <PosteriorDist>, <AnteriorY>, <PosteriorY>, <NumTouchingFloor>,
# <NumNonFeetTouchingFloor>, <Lifetime>) are filled only by its eager
# evaluator, not ported yet: they raise by name
_OBJECTIVE_TAG_TO_RESULT = {
    "<NormFinalDist>": "norm_final_dist",
    "<normAbsoluteDistance>": "norm_final_dist",
    "<normAbsoluteDisplacement>": "norm_final_dist",
    "<finalDistY>": "final_dist_y",
    "<normDistY>": "final_dist_y",
    "<NormRegimeDist>": "norm_regime_dist",
    "<NormFrozenDist>": "norm_frozen_dist",
    "<EndOfLifePosteriorY>": "end_of_life_posterior_y",
    "<FallAdjPostY>": "fall_adj_post_y",
    "<FoundNeedleInHaystack>": "found_needle",
    "<PushDist>": "push_dist",
    "<WindowDist>": "norm_window_dist",
}

# phase timing of the most recent _dispatch_batch (host prep vs device time,
# step buckets); read by the chip smoke run and the port's bench
LAST_DISPATCH_TIMING: dict = {}

_DEVO_KEYS = ("initial_voxel_size", "final_voxel_size", "growth_time",
              "start_growth_time")


def _phenotype_fields(ind, env):
    """build_body kwargs + env overrides from an individual's phenotype
    mapping (mirrors write_voxelyze_file's tag dispatch,
    read_write_voxelyze.py:44-48, 350-397)."""
    fields = {}
    env_overrides = {}
    for name, details in ind.genotype.to_phenotype_mapping.items():
        if details["env_kws"] is not None:
            for env_key, env_func in details["env_kws"].items():
                env_overrides[env_key] = env_func(details["state"])
            continue
        tag = details["tag"]
        if tag in _TAG_TO_FIELD:
            state = details["state"]
            if details["output_type"] is int:
                state = np.asarray(state, dtype=np.int32)
            else:
                state = np.asarray(state, dtype=np.float64)
            fields[_TAG_TO_FIELD[tag]] = state
    return fields, env_overrides


def _np_max_dt(structure, stiffness, palette_np, volume_effects=False):
    """Host-side CalcMaxDt (reference: VX_Sim.cpp:1693-1727) for the step
    count before launch: the max bond k/m in units of 1/L² (the caller
    applies the L² and 2π factors). With `volume_effects` the bond stiffness
    is Eh = E/((1-2u)(1+u)), the rest value of GetEffectiveStiffness
    (VXS_Bond.h:34)."""
    occ = structure > 0
    e = palette_np["elastic_mod"][structure]
    if stiffness is not None:
        e = np.where((stiffness > 0) & occ, stiffness, e)
    if volume_effects:
        u = palette_np["poisson"][structure]
        e = e / np.maximum((1.0 - 2.0 * u) * (1.0 + u), 1e-12)
    rho = palette_np["density"][structure]
    max_f2 = 0.0
    for d in range(3):
        occ2 = np.roll(occ, -1, axis=d)
        edge = np.ones_like(occ)
        sl = [slice(None)] * 3
        sl[d] = -1
        edge[tuple(sl)] = False
        mask = occ & occ2 & edge
        if not mask.any():
            continue
        e2 = np.roll(e, -1, axis=d)
        comp_e = np.where(e + e2 > 0, 2.0 * e * e2 / np.maximum(e + e2, 1e-30), 0.0)
        m1 = rho
        m2 = np.roll(rho, -1, axis=d)
        f2 = np.where(mask, comp_e / np.maximum(m1, 1e-30), 0.0)
        f2b = np.where(mask, comp_e / np.maximum(m2, 1e-30), 0.0)
        max_f2 = max(max_f2, float(f2.max()), float(f2b.max()))
    return max_f2


def _ladder_count(m: int) -> int:
    """Smallest {1, 1.5}·2^k integer ≥ m: the batch-size ladder (in
    batch_pad units) that keeps generation shapes few and repeated."""
    if m <= 1:
        return 1
    k = int(np.floor(np.log2(m)))
    for c in (2 ** k, 3 * 2 ** (k - 1) if k >= 1 else 2 ** k, 2 ** (k + 1)):
        if c >= m:
            return int(c)
    return int(2 ** (k + 1))


def _ladder_steps(n: int) -> int:
    """Quantize a step count UP to the {1, 1.25, 1.5, 1.75}·2^k·256 ladder
    (≤25% padded steps; stopped rollouts freeze, so padding is cheap). The
    quantized counts are the dt buckets of a generation."""
    base = 256
    while base < n:
        base *= 2
    if base == 256:
        return 256
    lo = base // 2
    for m in (1.25, 1.5, 1.75, 2.0):
        v = int(lo * m)
        if v >= n:
            return v
    return base


def make_fused_evaluator(palette, grid_shape, num_steps, field_names,
                         lattice_dim, sim_params, env_flags_src,
                         with_collision=False, fluid_mesh=False, device=None):
    """Batched evaluation through the fused rollout (`ops.fused_rollout`):
    per-individual bodies, envs, dt and stop time ride per-robot channels,
    so a batch is ONE launch. `fluid_mesh`: the facet drag on the deformed
    mesh; the caller pads the grid with the one-cell corner shell. Speed
    windows over an evolved final size run ballistic development, each
    robot's state carrying its DevoState. Returns
    `fn(structures, voxel_fields, env_batch, stop_time,
    collision_packed=None, num_steps=None)` -> dict of numpy metrics;
    `collision_packed` is the (B, V, V) float32 pair-table batch and
    `num_steps` overrides the launch's step count. Bilinear and MDL_DATA palettes
    run the nonlinear stress, with each robot's MDL_DATA tables (B, 2P + 3,
    V) streamed beside its body."""
    device = resolve_device(device)
    V = int(np.prod(grid_shape))
    has_mdl = palette.ss_strain is not None
    vol = bool(sim_params.volume_effects_enabled)
    scalars = fr.kernel_scalars(lattice_dim, sim_params, env_flags_src)
    flags = dict(
        fr.kernel_env_flags(sim_params, env_flags_src),
        nonlinear=bool((palette.mat_model >= 2).any()),
        mdl_data=has_mdl,
        bc=False,
        fluid_mesh=bool(fluid_mesh),
        use_init_size="initial_voxel_size" in field_names,
        use_final_size="final_voxel_size" in field_names,
        use_growth_t="growth_time" in field_names,
        use_final_phase="final_phase_offset" in field_names,
        use_final_ad="final_temp_amp_damp" in field_names,
        ballistic=bool(int(env_flags_src.num_trace_steps_in_window) > 0
                       and "final_voxel_size" in field_names),
        collision=bool(with_collision),
    )
    fr.check_envelope(flags, scalars)
    dt_frac = float(sim_params.dt_frac)

    def pack_one(structure, voxel_fields, env1, stop_time):
        # bodies are built on the host and copied to the device once per batch
        body = build_body(structure, palette, lattice_dim=lattice_dim,
                          **voxel_fields)
        dt = calc_max_dt(body, vol) * dt_frac
        sp = fr.pack_state_single(init_state(body, volume_effects=vol,
                                             ballistic_devo=flags["ballistic"]))
        bp = fr.pack_body(body)[0]
        row = fr.make_stats(body, 1, dt, sim_params, env1, stop_time)[0]
        ss = fr.pack_ss_tables(body)[0] if has_mdl else None
        return sp, bp, row, ss

    def pack(structures, voxel_fields, env_batch, stop_time, collision_packed=None):
        if fr.facet_drag(flags) and not fr.has_corner_shell(np.asarray(structures) > 0):
            raise ValueError(fr.NO_SHELL)
        packed = [
            pack_one(structures[i], {k: v[i] for k, v in voxel_fields.items()},
                     env_batch[i], stop_time)
            for i in range(len(structures))
        ]
        sp, bp, rows = (torch.stack(x).to(device) for x in list(zip(*packed))[:3])
        ss = torch.stack([p[3] for p in packed]).to(device) if has_mdl else None
        col = None
        if with_collision:
            col = torch.as_tensor(collision_packed, device=device)
            if tuple(col.shape[1:]) != (V, V):
                raise ValueError(f"pair tables must be (B, {V}, {V})")
        return sp, bp, rows, col, ss

    launch_kw = dict(num_steps=num_steps, grid_shape=tuple(grid_shape),
                     scalars=scalars, flags=flags)

    def fn(structures, voxel_fields, env_batch, stop_time,
           collision_packed=None, num_steps=None):
        t0 = time.time()
        sp, bp, rows, col, ss = pack(structures, voxel_fields, env_batch, stop_time,
                                     collision_packed)
        t1 = time.time()
        kw = launch_kw if num_steps is None else dict(launch_kw, num_steps=num_steps)
        out_state, out_stats = fr.fused_call(sp, bp, rows, col, ss_packed=ss, **kw)
        m = fr.packed_metrics(
            out_state, bp, out_stats, lattice_dim, ndbv=flags["ndbv"],
            falling=flags["falling"], needle=flags["needle"], window=flags["window"],
            # the fall-over penalty uses the workspace's height: less the
            # corner shell's layer when the grid carries it
            grid_z=grid_shape[2] - (1 if fluid_mesh else 0))
        out = {k: v.cpu().numpy() for k, v in m.items()}  # waits for the device
        # the host waits on the launch, so launch_s is the device's busy time
        # plus one small copy back
        LAST_DISPATCH_TIMING["pack_s"] = t1 - t0
        LAST_DISPATCH_TIMING["launch_s"] = time.time() - t1
        return out

    # the packed tensors (state, body, stats, pair table, MDL_DATA tables or
    # None) and keywords of the launch, for holding the kernel against its
    # plain version on exactly what the evaluator gives it
    fn.pack = pack
    fn.launch_kw = launch_kw
    return fn


def evaluate_all(
    sim,
    env,
    pop,
    print_log=None,
    save_vxa_every=0,
    run_directory=None,
    run_name=None,
    max_eval_time=60,
    time_to_try_again=10,
    save_lineages=False,
    batch_pad=8,
    device=None,
):
    """Evaluate every unevaluated individual in `pop` in batched launches
    on `device`: the card when none is named (without a card that raises;
    `device="cpu"` asks for the plain versions). Signature-compatible with the reference's evaluate_all
    (tools/evaluation.py:18); `max_eval_time` / `time_to_try_again` are the
    reference's subprocess retry timers and are unused, as in the JAX
    package."""
    device = resolve_device(device)
    start = time.time()
    from evosoro_tpu_torch.evo.logging import PrintLog

    if print_log is None:
        print_log = PrintLog()

    to_eval = []
    for ind in pop:
        ind.md5 = ind.genotype.phenotype_md5()

        if not ind.phenotype.is_valid():
            for rank, goal in pop.objective_dict.items():
                if goal["name"] != "age":
                    setattr(ind, goal["name"], goal["worst_value"])
            print_log.message("Skipping invalid individual")
        elif env.actuation_variance == 0 and ind.md5 in pop.already_evaluated:
            for rank, goal in pop.objective_dict.items():
                if goal["tag"] is not None:
                    setattr(ind, goal["name"], pop.already_evaluated[ind.md5][rank])
        else:
            to_eval.append(ind)

    if to_eval:
        _dispatch_batch(sim, env, pop, to_eval, print_log,
                        batch_pad=batch_pad, device=device)

    # bookkeeping identical to the reference path (evaluation.py:160-184)
    for ind in to_eval:
        pop.already_evaluated[ind.md5] = [
            getattr(ind, details["name"])
            for rank, details in pop.objective_dict.items()
        ]
        pop.all_evaluated_individuals_ids += [ind.id]
        pop.total_evaluations += 1
        if ind.fitness > pop.best_fit_so_far:
            pop.best_fit_so_far = ind.fitness
            if run_directory is not None:
                _archive_best(sim, env, ind, run_directory, run_name, pop.gen)

    print_log.message(
        "All evals finished in {:.3f} seconds".format(time.time() - start)
    )
    print_log.message("total_evaluations: {}".format(pop.total_evaluations))
    return pop


def _batch_fields(sim, env, inds):
    """Per-individual build_body fields, EnvParams and ladder step counts."""
    grid = inds[0].genotype.orig_size_xyz
    sim_params = sim.to_sim_params()
    all_fields = []
    all_env = []
    for ind in inds:
        fields, env_over = _phenotype_fields(ind, env)
        if "structure" not in fields:
            # fixed-topology experiments: all voxels material 3
            # (reference: read_write_voxelyze.py:352-359)
            fields["structure"] = np.full(grid, 3, dtype=np.int32)
        this_env = copy.copy(env)
        for k, v in env_over.items():
            setattr(this_env, k, v)
        if env.actuation_variance > 0:
            # per-evaluation noise on muscle CTE: an independent uniform draw
            # per muscle material (read_write_voxelyze.py:243, 267)
            scale = np.ones(tuple(grid), dtype=np.float32)
            struct_arr = fields["structure"]
            for m in _experiment_palette(env):
                if m.cte != 0.0:
                    scale[struct_arr == m.id] = 1.0 + np.random.uniform(
                        0, env.actuation_variance
                    )
            fields["cte_scale"] = scale
        env_params = this_env.to_env_params()
        if any(k in fields for k in _DEVO_KEYS):
            # the genome's devo outputs are normalized sigmoids; the engine
            # maps them to physical sizes and absolute times at import
            # (reference: VX_Sim.cpp:878-965)
            raw = {k.replace("_", ""): fields.pop(k, None) for k in _DEVO_KEYS}
            fields.update(devo_params_from_vxa(
                raw, sim_params, env_params, env.lattice_dimension,
                fields["structure"]))
        all_fields.append(fields)
        all_env.append(env_params)

    palette = palette_from_list(_experiment_palette(env))
    palette_np = {
        "elastic_mod": palette.elastic_mod.numpy().astype(np.float64),
        "density": palette.density.numpy().astype(np.float64),
        "poisson": palette.poisson.numpy().astype(np.float64),
    }
    L = env.lattice_dimension
    vol_on = bool(sim_params.volume_effects_enabled)
    stop_time = float(sim.simulation_time)

    def _steps_for(f):
        # per-design step count: CalcMaxDt is design-dependent
        # (reference: VX_Sim.cpp:1693-1727)
        f2 = _np_max_dt(f["structure"], f.get("stiffness"), palette_np,
                        volume_effects=vol_on)
        freq = np.sqrt(f2 / (L * L))
        mdt = ((1.0 / (2 * np.pi * freq)) * sim.dt_frac
               if freq > 0 else 1e-4)
        s = int(np.ceil(stop_time / mdt)) + 1
        if vol_on:
            # the dt recomputed in every step shrinks under compression
            s = int(np.ceil(s * 1.15))
        return _ladder_steps(s)

    return all_fields, all_env, [_steps_for(f) for f in all_fields]


def _launch_inputs(sim, env, grid, all_fields, all_env, num_steps, batch_pad,
                   device):
    """The fused evaluator of one launch and its host inputs: returns
    (fn, inputs, padded batch size), with fn(*inputs) -> metrics."""
    sim_params = sim.to_sim_params()
    palette = palette_from_list(_experiment_palette(env))
    L = env.lattice_dimension
    field_names = sorted(set().union(*[set(f) for f in all_fields]) - {"structure"})
    B = len(all_fields)
    # batch padded UP the {1, 1.5}·2^k ladder in batch_pad units; pad rows
    # reuse row 0's design and their results are discarded
    Bp = _ladder_count(-(-B // batch_pad)) * batch_pad
    structures = np.zeros((Bp,) + tuple(grid), dtype=np.int32)
    voxel_fields = {
        k: np.zeros((Bp,) + tuple(grid), dtype=np.float32) for k in field_names
    }
    for i, f in enumerate(all_fields):
        structures[i] = f["structure"]
        for k in field_names:
            if k in f:
                voxel_fields[k][i] = f[k]
    for i in range(B, Bp):
        structures[i] = structures[0]
        for k in field_names:
            voxel_fields[k][i] = voxel_fields[k][0]
    env_batch = all_env + [all_env[0]] * (Bp - B)

    # fluid environments: the default drag model is the facet drag on the
    # deformed surface mesh (land_water VX_Sim.cpp:1516-1600);
    # `Env(drag_model="voxel_face")` opts into the voxel-face approximation
    use_mesh_drag = bool(all_env[0].fluid_environment) \
        and getattr(env, "drag_model", "mesh") == "mesh"
    if use_mesh_drag:
        # corner-shell padding: the kernel computes the facets as a stencil
        # over corner-lattice points, which needs one empty layer at the
        # +X/+Y/+Z faces (ops.fused_rollout.supports). Padded before the
        # pair tables are built, so flat indices agree.
        shell = ((0, 0), (0, 1), (0, 1), (0, 1))
        structures = np.pad(structures, shell)
        voxel_fields = {k: np.pad(v, shell) for k, v in voxel_fields.items()}
        grid = tuple(g + 1 for g in grid)

    # self-collision: every reference experiment defaults SelfColEnabled=1
    # (base.py:24); the static tables are host-built per design and packed
    # to dense (V, V) pair tables
    with_collision = bool(sim_params.self_collisions_enabled)
    collision_packed = None
    if with_collision:
        from evosoro_tpu_torch.core.collision import build_collision_system

        e_pal = palette.elastic_mod.numpy()
        stiff = voxel_fields.get("stiffness")
        tables = []
        for i in range(Bp):
            if i >= B:  # pad rows duplicate row 0's design
                tables.append(tables[0])
                continue
            st_i = structures[i]
            e_vox = e_pal[st_i]
            if stiff is not None:
                e_vox = np.where((stiff[i] > 0) & (st_i > 0), stiff[i], e_vox)
            tables.append(fr.pack_collision(
                build_collision_system(st_i, e_vox, L), tuple(grid)))
        collision_packed = np.stack(tables)

    fn = make_fused_evaluator(
        palette, tuple(grid), num_steps, tuple(field_names), L, sim_params,
        all_env[0], with_collision=with_collision, fluid_mesh=use_mesh_drag,
        device=device)
    inputs = (structures, voxel_fields, env_batch, float(sim.simulation_time),
              collision_packed)
    return fn, inputs, Bp


def evaluator_batch(sim, env, inds, batch_pad=8, device=None):
    """The fused evaluator and its host inputs for one launch over `inds`,
    made as `_dispatch_batch` makes them (at the largest step count of
    `inds`): (fn, inputs) with fn(*inputs) -> metrics; `fn.pack(*inputs)`
    gives the launch's packed tensors (state, body, stats, pair table,
    MDL_DATA tables) and `fn.launch_kw` its keywords."""
    all_fields, all_env, per_steps = _batch_fields(sim, env, inds)
    fn, inputs, _ = _launch_inputs(sim, env, inds[0].genotype.orig_size_xyz,
                                   all_fields, all_env, max(per_steps),
                                   batch_pad, device)
    return fn, inputs


def _dispatch_batch(sim, env, pop, inds, print_log, batch_pad=8, device=None,
                    _bucketed=False):
    _t0 = time.time()
    _tm = LAST_DISPATCH_TIMING
    _tm.clear()

    for rank, details in pop.objective_dict.items():
        tag = details["tag"]
        if tag is not None and tag not in _OBJECTIVE_TAG_TO_RESULT:
            raise NotImplementedError(f"objective tag {tag} is not ported yet")

    all_fields, all_env, per_steps = _batch_fields(sim, env, inds)
    buckets = sorted(set(per_steps))

    if len(buckets) > 1 and not _bucketed:
        # dt-bucketed dispatch: one launch per step bucket, so a single stiff
        # mutant (small dt -> 10x the steps) doesn't make the whole
        # generation ride its step count
        merged = dict(host_prep_s=0.0, pack_s=0.0, launch_s=0.0, device_s=0.0,
                      batch=0, batch_padded=0, redispatches=0,
                      short_after_redispatch=0, short_final_times=[], short_ids=[],
                      num_steps=max(per_steps), buckets=[])
        for bval in buckets:
            group = [ind for ind, s in zip(inds, per_steps) if s == bval]
            _dispatch_batch(sim, env, pop, group, print_log,
                            batch_pad=batch_pad, device=device, _bucketed=True)
            for k in ("host_prep_s", "pack_s", "launch_s", "device_s", "batch",
                      "batch_padded", "redispatches", "short_after_redispatch",
                      "short_final_times", "short_ids"):
                merged[k] += _tm.get(k, type(merged[k])())
            merged["buckets"].append(dict(num_steps=bval, batch=len(group)))
        _tm.clear()
        _tm.update(merged)
        return

    B = len(inds)
    num_steps = max(per_steps)
    fn, inputs, Bp = _launch_inputs(sim, env, inds[0].genotype.orig_size_xyz,
                                    all_fields, all_env, num_steps, batch_pad,
                                    device)
    _tm["host_prep_s"] = time.time() - _t0  # fields, step counts, pair tables
    _td = time.time()
    if sim.to_sim_params().volume_effects_enabled:
        # the dt shrinks under compression: a live rollout short of the stop
        # time launches the batch again, longer (core.rollout)
        stop_time = float(sim.simulation_time)

        def log(n_short, steps):
            print_log.message(
                "{} rollouts truncated before stop time under dynamic dt; "
                "re-dispatching with scan length {}".format(n_short, steps))

        results, num_steps, _tm["redispatches"], short = relaunch_until_stop(
            lambda n: fn(*inputs, num_steps=n), num_steps,
            lambda r: ~r["diverged"][:B] & (r["final_time"][:B] < stop_time * 0.999),
            log)
    else:
        results = fn(*inputs)
        _tm["redispatches"], short = 0, np.zeros(B, dtype=bool)
    # the rollouts that still end short are scored as they are, as in the
    # JAX package: their count, final times and ids are recorded
    _tm["short_after_redispatch"] = int(short.sum())
    _tm["short_final_times"] = [float(t) for t in results["final_time"][:B][short]]
    _tm["short_ids"] = [inds[i].id for i in np.flatnonzero(short)]
    _tm["device_s"] = time.time() - _td  # pack_s + launch_s
    _tm["batch"] = B
    _tm["batch_padded"] = int(Bp)
    _tm["num_steps"] = int(num_steps)
    _tm["buckets"] = [dict(num_steps=int(num_steps), batch=B)]

    # objective assignment (reference: evaluation.py:160-177)
    for i, ind in enumerate(inds):
        for rank, details in pop.objective_dict.items():
            tag = details["tag"]
            if tag is not None:
                val = float(results[_OBJECTIVE_TAG_TO_RESULT[tag]][i])
                if bool(results["diverged"][i]):
                    val = details["worst_value"]
                setattr(ind, details["name"], val)
            elif details["node_func"] is not None:
                for name, det_ph in ind.genotype.to_phenotype_mapping.items():
                    if name == details["output_node_name"]:
                        setattr(
                            ind, details["name"], details["node_func"](det_ph["state"])
                        )
        print_log.message(
            "id {0} fit = {1} ({2}/{3})".format(ind.id, ind.fitness, i + 1, len(inds))
        )


def _experiment_palette(env):
    """The canonical 7-material palette parameterized by experiment
    stiffnesses (reference: read_write_voxelyze.py:175-344), or the
    experiment's own `Env(materials=[...])`."""
    mats = getattr(env, "materials", None)
    if mats:
        return list(mats)
    return evosoro_default_palette(
        fat_stiffness=getattr(env, "fat_stiffness", 5e6),
        bone_stiffness=getattr(env, "bone_stiffness", 5e8),
        muscle_stiffness=getattr(env, "muscle_stiffness", 5e6),
    )


def _archive_best(sim, env, ind, run_directory, run_name, gen):
    """Write the new best-so-far design as a .vxa (reference archives the
    input file: evaluation.py:185-192)."""
    import os

    from evosoro_tpu_torch.io.vxa import write_vxa

    os.makedirs(os.path.join(run_directory, "bestSoFar", "fitOnly"), exist_ok=True)
    fields, _ = _phenotype_fields(ind, env)
    structure = fields.pop(
        "structure", np.full(ind.genotype.orig_size_xyz, 3, dtype=np.int32)
    )
    tag_map = {v: k for k, v in _TAG_TO_FIELD.items()}
    voxel_arrays = {
        tag_map[k].strip("<>"): v for k, v in fields.items() if k in tag_map
    }
    path = os.path.join(
        run_directory,
        "bestSoFar",
        "fitOnly",
        "{0}--Gen_{1:04d}--fit_{2:.08f}--id_{3:05d}.vxa".format(
            run_name or "run", gen, ind.fitness, ind.id
        ),
    )
    write_vxa(
        path,
        structure,
        _experiment_palette(env),
        sim=sim.to_sim_params(),
        env=env.to_env_params(),
        voxel_arrays=voxel_arrays,
    )
