"""Model FLOPs of a training step, counted from the configuration.

6 FLOPs a matmul parameter a token (forward 2, backward 4), the LM head
included and the embedding lookup not, plus causal self-attention
(``6 * L * H * hd * S`` a token: QK^T and PV, half of each masked away,
times three for the backward).  Recomputation under activation
checkpointing is not counted.  A MoE layer counts the router, its
``top_k`` routed experts and its shared experts a token: not the
capacity slots, not the dispatch and combine einsums.
"""
from __future__ import annotations


def _attn_params(m: dict) -> int:
    d, h, k = m["d_model"], m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or d // h
    return d * h * hd + 2 * d * k * hd + h * hd * d


def _mlp_mults(m: dict) -> int:
    return 3 if m.get("mlp_variant", "swiglu") == "swiglu" else 2


def matmul_params_per_token(m: dict) -> int:
    """Matmul parameters one token passes through (active parameters,
    embedding lookup excluded, head included)."""
    d, v = m["d_model"], m["vocab_size"]
    n_layers = m["num_layers"]
    attn = _attn_params(m)
    moe = m.get("moe")
    if moe:
        de, k, ns = moe["d_expert"], moe["top_k"], moe.get("num_shared", 0)
        dense = moe.get("first_dense", 0)
        per_dense = attn + _mlp_mults(m) * d * de * (k + ns)
        per_moe = (attn + d * moe["num_experts"]
                   + _mlp_mults(m) * d * de * (k + ns))
        body = dense * per_dense + (n_layers - dense) * per_moe
    else:
        body = n_layers * (attn + _mlp_mults(m) * d * m["d_ff"])
    return body + d * v


def attention_flops_per_token(m: dict, seq_len: int) -> int:
    """Causal self-attention's FLOPs a token, forward and backward."""
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    return 6 * m["num_layers"] * m["num_heads"] * hd * seq_len


def train_flops(m: dict, tokens: int, seq_len: int) -> int:
    """Model FLOPs of training on ``tokens`` tokens in sequences of
    ``seq_len``."""
    per_token = (6 * matmul_params_per_token(m)
                 + attention_flops_per_token(m, seq_len))
    return per_token * tokens
