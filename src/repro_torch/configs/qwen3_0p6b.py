"""qwen3-0.6b [dense]: qk-norm GQA decoder.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, head_dim=128
[hf:Qwen/Qwen3-8B family].  Same values as the reference's config.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    remat=True,
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
    dtype="float32",
    remat=False,
    full_size=False,
)
