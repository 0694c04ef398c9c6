"""Model definitions of the port: every family of the reference's zoo."""
from .config import SHAPES, ModelConfig, MoEConfig, ShapeCell, SsmConfig
from .transformer import (Transformer, count_params, decode_step,
                          forward, global_attention_flags,
                          init_cache, init_params, loss_fn, params_from_jax,
                          params_to_numpy)

__all__ = ["SHAPES", "ModelConfig", "MoEConfig",
           "ShapeCell", "SsmConfig", "Transformer", "count_params",
           "decode_step", "forward", "global_attention_flags", "init_cache",
           "init_params", "loss_fn", "params_from_jax", "params_to_numpy"]
