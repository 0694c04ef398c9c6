"""starcoder2-15b [dense]: GQA kv=4, RoPE, GeLU MLP.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152 [arXiv:2402.19173].
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    mlp_variant="gelu",
    qkv_bias=True,
    rope_theta=100000.0,
    dtype="bfloat16",
    remat=True,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    mlp_variant="gelu",
    qkv_bias=True,
    dtype="float32",
    remat=False,
    full_size=False,
)
