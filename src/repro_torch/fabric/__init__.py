"""The aggregation fabric of the PyTorch port: sessions, codecs, schedules,
hop plans."""
from . import backends  # noqa: F401  (registers the built-in schedules)
from . import extra_codecs  # noqa: F401  (registers int4 / topk)
from .codecs import (Codec, CodecLane, GradientCodec, MaskGate,
                     available_codecs, get_codec, register_codec,
                     resolve_leaf_gate_mask, ring_wire_bytes,
                     unregister_codec)
from .hierarchy import (INTRA_NODE_WORKERS, HierarchicalCodec, HopPlan,
                        HopSpec, register_hop_plan, unregister_hop_plan)
from .control import (Controller, ControlEvent, FP32Controller,
                      PaperController, Phase, PolicyProgram, StaticController,
                      Telemetry, available_controllers, get_controller,
                      make_controller, plan_from_jsonable, plan_presets,
                      plan_to_jsonable, register_controller,
                      register_plan_preset, unregister_controller,
                      unregister_plan_preset)
from .registry import (AggregationContext, ScheduleBackend,
                       available_schedules, get_schedule, register_schedule,
                       unregister_schedule)
from .session import (CompiledStep, Fabric, TrainState, aggregate_leaf,
                      aggregate_tree, aggregate_tree_bucketed,
                      dp_num_workers, layout_kernel_stats)

__all__ = [
    "AggregationContext", "Codec", "CodecLane", "CompiledStep",
    "ControlEvent", "Controller",
    "FP32Controller", "Fabric", "GradientCodec", "HierarchicalCodec",
    "HopPlan", "HopSpec", "INTRA_NODE_WORKERS", "MaskGate",
    "PaperController", "Phase", "PolicyProgram", "ScheduleBackend",
    "StaticController", "Telemetry", "TrainState", "aggregate_leaf",
    "aggregate_tree", "aggregate_tree_bucketed", "available_codecs",
    "available_controllers", "available_schedules", "dp_num_workers",
    "get_codec",
    "get_controller", "get_schedule", "layout_kernel_stats",
    "make_controller", "plan_from_jsonable", "plan_presets",
    "plan_to_jsonable", "register_codec", "register_controller",
    "register_hop_plan", "register_plan_preset", "register_schedule",
    "resolve_leaf_gate_mask", "ring_wire_bytes",
    "unregister_codec", "unregister_hop_plan",
    "unregister_controller", "unregister_plan_preset", "unregister_schedule",
]
