"""qwen2.5-14b [dense]: GQA with QKV bias.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, head_dim=128
[hf:Qwen/Qwen2.5 family].
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    dtype="bfloat16",
    remat=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    dtype="float32",
    remat=False,
    full_size=False,
)
