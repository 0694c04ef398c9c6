"""hymba-1.5b [hybrid]: parallel attention + Mamba-style SSM heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676].  Every layer runs a GQA path and a selective-SSM
path on the same input and averages their outputs; attention is
sliding-window (1024) except in the first, middle and last layers,
which are global.  Meta-tokens are omitted, as in the reference.  Same
values as the reference's config.
"""
from ..models.config import ModelConfig, SsmConfig

FULL = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    hybrid_parallel=True,
    ssm=SsmConfig(state_size=16, variant="mamba_head"),
    dtype="bfloat16",
    remat=True,
)

SMOKE = ModelConfig(
    name="hymba-smoke",
    family="hybrid",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    sliding_window=16,
    hybrid_parallel=True,
    ssm=SsmConfig(state_size=4, variant="mamba_head"),
    dtype="float32",
    remat=False,
    full_size=False,
)
