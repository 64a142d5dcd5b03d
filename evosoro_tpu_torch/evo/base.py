"""User-facing experiment parameter containers.

API parity with the reference's evosoro/base.py (Sim, Env, ObjectiveDict) so
experiment scripts port one-for-one, plus `.to_sim_params()` /
`.to_env_params()` adapters producing the port's core dataclasses (the
reference instead serializes these to VXA tags — base.py:9-18,
read_write_voxelyze.py:53-155). Copied from `evosoro_tpu.evo.base`.
"""

from __future__ import annotations

from evosoro_tpu_torch.core.types import EnvParams, SimParams
from evosoro_tpu_torch.utils.functional import xml_format


class VoxCadParams:
    """Base container; `add_param` registers ad-hoc tags
    (reference: base.py:9-18)."""

    def __init__(self):
        self.sub_groups = []
        self.new_param_tag_dict = {}

    def add_param(self, name, val, tag):
        setattr(self, name, val)
        self.new_param_tag_dict[name] = xml_format(tag)


class Sim(VoxCadParams):
    """Simulation parameters (reference: base.py:21-48)."""

    def __init__(
        self,
        self_collisions_enabled=True,
        simulation_time=10,
        dt_frac=0.7,
        stop_condition=2,
        fitness_eval_init_time=2,
        equilibrium_mode=0,
        min_temp_fact=0.1,
        max_temp_fact_change=0.00001,
        max_stiffness_change=10000,
        min_elastic_mod=5e006,
        max_elastic_mod=5e008,
        afterlife_time=0,
        mid_life_freeze_time=0,
    ):
        super().__init__()
        self.sub_groups = [
            "Integration",
            "Damping",
            "Collisions",
            "Features",
            "StopCondition",
            "EquilibriumMode",
            "GA",
        ]
        self.self_collisions_enabled = self_collisions_enabled
        self.simulation_time = simulation_time
        self.dt_frac = dt_frac
        self.stop_condition = stop_condition
        self.fitness_eval_init_time = fitness_eval_init_time
        self.equilibrium_mode = equilibrium_mode
        self.min_temp_fact = min_temp_fact
        self.max_temp_fact_change = max_temp_fact_change
        self.max_stiffness_change = max_stiffness_change
        self.min_elastic_mod = min_elastic_mod
        self.max_elastic_mod = max_elastic_mod
        self.afterlife_time = afterlife_time
        self.mid_life_freeze_time = mid_life_freeze_time

    def to_sim_params(self) -> SimParams:
        return SimParams(
            dt_frac=self.dt_frac,
            stop_condition_value=self.simulation_time,
            init_cm_time=self.fitness_eval_init_time,
            min_temp_fact=self.min_temp_fact,
            afterlife_time=self.afterlife_time,
            mid_life_freeze_time=self.mid_life_freeze_time,
            self_collisions_enabled=bool(self.self_collisions_enabled),
            equilibrium_mode=bool(self.equilibrium_mode),
        )


class Env(VoxCadParams):
    """Environment parameters (reference: base.py:50-74).

    `temp_amp` is the legacy *peak* temperature; the engine's actuation
    amplitude is temp_amp − temp_base (reference: VX_Environment.cpp:184-189).
    """

    def __init__(
        self,
        frequency=4.0,
        gravity_enabled=1,
        temp_enabled=1,
        floor_enabled=1,
        floor_slope=0.0,
        lattice_dimension=0.01,
        fat_stiffness=5e006,
        bone_stiffness=5e008,
        muscle_stiffness=5e006,
        sticky_floor=0,
        time_between_traces=0,
        actuation_variance=0,
        temp_amp=39,
        temp_base=25.0,
        grav_acc=-9.81,
        fluid_environment=0,
        aggregate_drag_coefficient=0.0,
        drag_model="mesh",
        materials=None,
    ):
        super().__init__()
        self.sub_groups = ["Fixed_Regions", "Forced_Regions", "Gravity", "Thermal"]
        self.frequency = frequency
        self.gravity_enabled = gravity_enabled
        self.floor_enabled = floor_enabled
        self.temp_enabled = temp_enabled
        self.floor_slope = floor_slope
        self.lattice_dimension = lattice_dimension
        self.muscle_stiffness = muscle_stiffness
        self.bone_stiffness = bone_stiffness
        self.fat_stiffness = fat_stiffness
        self.sticky_floor = sticky_floor
        self.time_between_traces = time_between_traces
        self.actuation_variance = actuation_variance
        self.temp_amp = temp_amp
        self.temp_base = temp_base
        self.grav_acc = grav_acc
        self.fluid_environment = fluid_environment
        self.aggregate_drag_coefficient = aggregate_drag_coefficient
        # which fluid-drag model the evaluator simulates under:
        # "mesh" (default) = the land_water fork's deformed-surface-mesh
        # facet drag (parity-validated, envs/drag.py); "voxel_face" = the
        # fused kernel's exposed-face approximation (~10x faster;
        # DRAGDIV.json quantifies the divergence + fitness-rank agreement)
        self.drag_model = drag_model
        # full-palette override (list of core.types.Material); the hook for
        # custom material-model experiments (bilinear/MDL_DATA). None keeps
        # the canonical 7-material palette parameterized by *_stiffness.
        self.materials = materials

    def to_env_params(self) -> EnvParams:
        # ad-hoc add_param() attributes become first-class EnvParams fields
        # when they exist (reference: base.py:16-18 add_param → VXA tags;
        # e.g. growth.py:98-99 GrowthAmplitude, swimming_basic.py:137-138
        # FluidEnvironment/AggregateDragCoefficient)
        g = lambda name, default: getattr(self, name, default)
        return EnvParams(
            grav_acc=self.grav_acc,
            floor_slope=self.floor_slope,
            temp_base=self.temp_base,
            temp_amplitude=self.temp_amp - self.temp_base,
            temp_period=1.0 / self.frequency,
            growth_amplitude=g("growth_amplitude", 0.0),
            floor_radius=g("floor_radius", 0.0),
            aggregate_drag_coefficient=self.aggregate_drag_coefficient,
            time_between_traces=g("time_between_traces", 0.0) or 0.01,
            normalization_exponent=g("normalization_exponent", 1.0),
            num_trace_steps_in_window=int(g("num_trace_steps_in_window", 0)),
            norm_dist_by_vol=bool(g("norm_dist_by_vol", False)),
            falling_prohibited=bool(g("falling_prohibited", False)),
            needle_in_haystack=bool(g("needle_in_haystack", False)),
            gravity_enabled=bool(self.gravity_enabled),
            floor_enabled=bool(self.floor_enabled),
            floor_limited=bool(g("floor_limited", False)),
            temp_enabled=bool(self.temp_enabled),
            vary_temp_enabled=True,
            sticky_floor=bool(self.sticky_floor),
            fluid_environment=bool(self.fluid_environment),
            lattice_dim=self.lattice_dimension,
            # environmental sources (envs.sources.make_sources), set like
            # the other add_param() attributes
            sources=g("sources", None),
        )


# Material container kept for API parity (unused in the reference as well —
# base.py:76-93)
class Material(VoxCadParams):
    def __init__(self, lattice_dimension=0.01, **_ignored):
        super().__init__()
        self.sub_groups = ["Lattice", "Voxel"]
        self.palette = {}

    def add_material_to_palette(self, id, *args, **kwargs):
        self.palette[id] = {"args": args, "kwargs": kwargs}


class ObjectiveDict(dict):
    """Ranked optimization objectives (reference: base.py:95-155).

    Keys are integer ranks (0 = most important); `fitness` auto-corrects to
    rank 0 regardless of insertion order.
    """

    def __init__(self):
        super().__init__()
        self.max_rank = 0

    def add_objective(
        self,
        name,
        maximize,
        tag,
        node_func=None,
        output_node_name=None,
        logging_only=False,
    ):
        curr_rank = self.max_rank
        if name == "fitness" and self.max_rank > 0:
            curr_rank = 0
            for rank in reversed(range(len(self))):
                self[rank + 1] = self[rank]

        super().__setitem__(
            curr_rank,
            {
                "name": name,
                "maximize": maximize,
                "tag": xml_format(tag) if tag is not None else None,
                "worst_value": -10e6 if maximize else 10e6,
                "node_func": node_func,
                "output_node_name": output_node_name,
                "logging_only": logging_only,
            },
        )
        self.max_rank += 1
