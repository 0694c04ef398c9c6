"""llama4-scout-17b-a16e [moe]: 16-expert top-1 MoE with shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Every layer is MoE
(top-1 routed + 1 shared expert, Llama-4 style); early fusion is a no-op
here because the assigned shape set is text-only.
"""
from ..models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=202048,
    rope_theta=500000.0,
    moe=MoEConfig(num_experts=16, top_k=1, d_expert=8192, num_shared=1,
                  capacity_factor=2.0, group_size=1024),
    dtype="bfloat16",
    remat=True,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=1, d_expert=64, num_shared=1,
                  capacity_factor=2.0, group_size=32),
    dtype="float32",
    remat=False,
    full_size=False,
)
