"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP patch-embed stub.

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct].  The modality frontend is a
stub: a batch may carry precomputed CLIP-like patch features
``patch_feats`` (B, 576, 1024), which the trained projector maps into the
token stream (prepended); the transformer backbone is exact.  Same
values as the reference's config.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    mlp_variant="swiglu",
    vision_patches=576,
    vision_feat_dim=1024,
    dtype="bfloat16",
    remat=True,
)

SMOKE = ModelConfig(
    name="phi-3-vision-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    vision_patches=8,
    vision_feat_dim=32,
    dtype="float32",
    remat=False,
    full_size=False,
)
