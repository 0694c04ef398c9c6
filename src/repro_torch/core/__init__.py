"""Aggregation math and policy vocabulary of the PyTorch port."""
from .buckets import (DEFAULT_BUCKET_BYTES, AdmissionPlan, Bucket, BucketGate,
                      BucketKey, BucketLayout, BucketSlot, GroupPolicy,
                      GroupRules, UnfusedLeaf, assign_groups, group_sizes,
                      leaf_bucket_key, path_name, plan_buckets,
                      resolve_policies)
from .aggregate import aggregate_gradients, init_ef_states, make_policy_tree
from .admission import (Commander, ControlEvent, CusumGuard, Predictor,
                        Supervisor)
from .collectives import (DistributedGroup, LocalGroup, ProcessMesh,
                          VirtualGroup, VirtualMesh)
from .device import rank_device, resolve_device
from .diagnostics import (cosines_to_host, group_cosines_from_mean,
                          group_cosines_from_workers)
from .lowbit import (LeafPolicy, aggregate_leaf, fp32_allreduce,
                     lowbit_packed_a2a, lowbit_vote_psum, majority_sign_sgd,
                     sign_of_mean)
from .modes import (AggregationMode, Schedule, bits_per_element,
                    canonical_mode, codec_name, schedule_name, traffic_ratio,
                    wire_schedule)
from .exposure import ExposureModel, TpuDatapathModel, envelope_sweep
from .traffic import (IciModel, MultiHopModel, hop_wire_bytes_per_device,
                      modeled_comm_time, modeled_layout_comm_time,
                      modeled_layout_multihop_time, payload_bytes,
                      plan_traffic_ratio, wire_bytes_per_device)

__all__ = [
    "DEFAULT_BUCKET_BYTES", "AdmissionPlan", "AggregationMode", "Bucket",
    "BucketGate", "BucketKey", "BucketLayout", "BucketSlot", "Commander",
    "ControlEvent", "CusumGuard", "DistributedGroup", "ExposureModel",
    "GroupPolicy", "GroupRules", "IciModel", "LeafPolicy", "LocalGroup",
    "MultiHopModel", "Predictor", "ProcessMesh", "Schedule", "Supervisor",
    "TpuDatapathModel", "UnfusedLeaf", "VirtualGroup", "VirtualMesh",
    "aggregate_gradients", "aggregate_leaf", "assign_groups",
    "bits_per_element", "canonical_mode", "codec_name",
    "cosines_to_host", "envelope_sweep", "fp32_allreduce",
    "group_cosines_from_mean", "group_cosines_from_workers", "group_sizes",
    "hop_wire_bytes_per_device", "init_ef_states", "leaf_bucket_key",
    "lowbit_packed_a2a", "lowbit_vote_psum", "majority_sign_sgd",
    "make_policy_tree", "modeled_comm_time",
    "modeled_layout_comm_time", "modeled_layout_multihop_time",
    "path_name", "payload_bytes", "plan_buckets", "plan_traffic_ratio",
    "rank_device",
    "resolve_device",
    "resolve_policies", "schedule_name", "sign_of_mean", "traffic_ratio",
    "wire_bytes_per_device", "wire_schedule",
]
