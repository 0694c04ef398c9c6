"""deepseek-moe-16b [moe]: fine-grained 64-expert top-6 + 2 shared experts.

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400 [arXiv:2401.06066].
d_ff = 1408 is the *expert* hidden size; layer 0 keeps a dense FFN
(first_dense=1, per the DeepSeekMoE architecture).
"""
from ..models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=102400,
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                  first_dense=1, capacity_factor=1.25, group_size=1024),
    dtype="bfloat16",
    remat=True,
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=2,
                  first_dense=1, capacity_factor=1.25, group_size=32),
    dtype="float32",
    remat=False,
    full_size=False,
)
