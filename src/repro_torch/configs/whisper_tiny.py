"""whisper-tiny [audio]: encoder-decoder over a stubbed conv frontend.

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 [arXiv:2212.04356].  The
batch carries precomputed frame embeddings ``frames`` (B, 1500,
d_model); a learned frame projector stands in for the two conv layers.
Encoder and decoder are 4 layers each; RoPE replaces Whisper's learned
absolute positions, as in the reference.  Same values as the
reference's config.
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    mlp_variant="gelu",
    tie_embeddings=True,
    dtype="bfloat16",
    remat=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    num_layers=2,
    encoder_layers=2,
    encoder_seq=16,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    mlp_variant="gelu",
    dtype="float32",
    remat=False,
    full_size=False,
)
