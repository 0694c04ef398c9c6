"""Model configuration (port of ``repro/models/config.py``).

One config dataclass covers every architecture the reference carries:
dense decoders (qwen3, qwen2.5, gemma3, starcoder2), MoE decoders
(llama4-scout, deepseek-moe), SSM and hybrid stacks (xlstm, hymba), the
encoder-decoder (whisper) and the VLM backbone (phi-3-vision); the
port's model runs all of them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # expert FFN hidden size
    num_shared: int = 0           # shared (always-on) experts
    first_dense: int = 0          # leading dense-FFN layers (DeepSeekMoE)
    capacity_factor: float = 1.25
    group_size: int = 1024        # tokens per dispatch group


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    state_size: int = 16
    variant: str = "mamba_head"   # mamba_head | mlstm | slstm
    slstm_every: int = 0          # xLSTM: every Nth block is sLSTM (0 = none)
    proj_factor: float = 2.0      # xLSTM block up-projection factor


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention variants
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # local-attention window
    global_every: Optional[int] = None     # every Nth layer is global (gemma3 6)
    mlp_variant: str = "swiglu"            # swiglu | gelu

    # mixtures
    moe: Optional[MoEConfig] = None
    ssm: Optional[SsmConfig] = None
    hybrid_parallel: bool = False          # hymba: attn + ssm heads in parallel

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500                # fixed frame count after conv stub

    # vlm (phi-3-vision): stub projector over precomputed patch features
    vision_patches: int = 0
    vision_feat_dim: int = 1024

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True                     # activation checkpoint per layer
    remat_policy: str = "full"             # full | dots (save dot/AR outputs)

    # smoke-test reduction hint (False = this IS a reduced config)
    full_size: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the 500k-token long-context cell."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers + head)."""
        d, v = self.d_model, self.vocab_size
        n = v * d                                   # embedding
        if not self.tie_embeddings:
            n += d * v                              # head
        per_layer = self._per_layer_params()
        n += self.num_layers * per_layer
        if self.encoder_layers:
            n += self.encoder_layers * per_layer
        return n

    def _per_layer_params(self) -> int:
        d, hd = self.d_model, self.hd
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        if self.moe:
            m = self.moe
            mults = 3 if self.mlp_variant == "swiglu" else 2
            ffn = m.num_experts * mults * d * m.d_expert \
                + m.num_shared * mults * d * m.d_expert + d * m.num_experts
        elif self.d_ff:
            mults = 3 if self.mlp_variant == "swiglu" else 2
            ffn = mults * d * self.d_ff
        else:
            ffn = 0
        ssm = 0
        if self.ssm is not None:
            ssm = int(4 * d * d * self.ssm.proj_factor / 2)
        return attn + ffn + ssm + 2 * d

    def active_param_count(self) -> int:
        """Active params per token (= total for dense; top-k for MoE)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        m = self.moe
        mults = 3 if self.mlp_variant == "swiglu" else 2
        dense_ffn_active = (m.top_k + m.num_shared) * mults * d * m.d_expert
        full_ffn = m.num_experts * mults * d * m.d_expert \
            + m.num_shared * mults * d * m.d_expert
        return self.param_count() - self.num_layers * (full_ffn - dense_ffn_active
                                                       - d * m.num_experts)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (arch x input-shape) evaluation cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)
