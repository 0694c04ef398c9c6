"""The aggregation fabric of the PyTorch port: sessions, codecs, schedules."""
from . import backends  # noqa: F401  (registers the built-in schedules)
from . import extra_codecs  # noqa: F401  (registers int4 / topk)
from .codecs import (Codec, GradientCodec, MaskGate, available_codecs,
                     get_codec, register_codec, unregister_codec)
from .control import plan_presets
from .registry import (AggregationContext, ScheduleBackend,
                       available_schedules, get_schedule, register_schedule,
                       unregister_schedule)
from .session import (Fabric, TrainState, aggregate_leaf, aggregate_tree,
                      aggregate_tree_bucketed, layout_kernel_stats)

__all__ = [
    "AggregationContext", "Codec", "Fabric", "GradientCodec", "MaskGate",
    "ScheduleBackend", "TrainState", "aggregate_leaf", "aggregate_tree",
    "aggregate_tree_bucketed", "available_codecs", "available_schedules",
    "get_codec", "get_schedule", "layout_kernel_stats", "plan_presets",
    "register_codec", "register_schedule", "unregister_codec",
    "unregister_schedule",
]
