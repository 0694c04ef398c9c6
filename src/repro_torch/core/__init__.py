"""Aggregation math and policy vocabulary of the PyTorch port."""
from .buckets import (DEFAULT_BUCKET_BYTES, AdmissionPlan, Bucket, BucketGate,
                      BucketKey, BucketLayout, BucketSlot, GroupPolicy,
                      GroupRules, UnfusedLeaf, assign_groups, group_sizes,
                      leaf_bucket_key, plan_buckets, resolve_policies)
from .collectives import LocalGroup, VirtualGroup
from .device import resolve_device
from .lowbit import (LeafPolicy, fp32_allreduce, lowbit_packed_a2a,
                     lowbit_vote_psum)
from .modes import (AggregationMode, Schedule, bits_per_element, codec_name,
                    schedule_name, wire_schedule)
from .traffic import payload_bytes, plan_traffic_ratio, wire_bytes_per_device

__all__ = [
    "DEFAULT_BUCKET_BYTES", "AdmissionPlan", "AggregationMode", "Bucket",
    "BucketGate", "BucketKey", "BucketLayout", "BucketSlot", "GroupPolicy",
    "GroupRules", "LeafPolicy", "LocalGroup", "Schedule", "UnfusedLeaf",
    "VirtualGroup",
    "assign_groups", "bits_per_element", "codec_name", "fp32_allreduce",
    "group_sizes", "leaf_bucket_key", "lowbit_packed_a2a", "lowbit_vote_psum",
    "payload_bytes", "plan_buckets", "plan_traffic_ratio", "resolve_device",
    "resolve_policies", "schedule_name",
    "wire_bytes_per_device", "wire_schedule",
]
