"""xlstm-125m [ssm]: sLSTM + mLSTM blocks (attention-free).

12L d_model=768 4H d_ff=0 vocab=50304 [arXiv:2405.04517].  Every 4th
block is an sLSTM (scalar memory with recurrent gating), the rest are
mLSTM blocks (matrix memory, exponential gating, a 2x up-projection).
Same values as the reference's config.
"""
from ..models.config import ModelConfig, SsmConfig

FULL = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm=SsmConfig(state_size=16, variant="mlstm", slstm_every=4,
                  proj_factor=2.0),
    dtype="bfloat16",
    remat=True,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    ssm=SsmConfig(state_size=4, variant="mlstm", slstm_every=4,
                  proj_factor=2.0),
    dtype="float32",
    remat=False,
    full_size=False,
)
