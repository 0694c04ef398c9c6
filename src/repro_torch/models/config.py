"""Model configuration (port of ``repro/models/config.py``, dense family).

The port runs the dense decoder family of the reference's one config
class as qwen3 uses it: GQA attention with optional qk-norm, RoPE, and a
SwiGLU MLP.  The reference's qkv-bias and GELU variants and its MoE,
SSM, hybrid, encoder-decoder and vision fields are still to port
(ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # only "dense" is ported
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    qk_norm: bool = False
    rope_theta: float = 10000.0

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True                     # activation checkpoint per layer

    # smoke-test reduction hint (False = this IS a reduced config)
    full_size: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads
