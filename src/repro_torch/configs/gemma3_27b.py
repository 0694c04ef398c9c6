"""gemma3-27b [dense]: 5:1 local:global interleaved attention, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144, head_dim=128
[hf:google/gemma-3; unverified].  Sliding window 1024 on local layers;
every 6th layer is global.  qk-norm per gemma3.  Eligible for the
long_500k cell: local layers are O(window).  Same values as the
reference's config.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    qk_norm=True,
    sliding_window=1024,
    global_every=6,
    rope_theta=1000000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    remat=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
    sliding_window=8,
    global_every=3,
    dtype="float32",
    remat=False,
    full_size=False,
)
