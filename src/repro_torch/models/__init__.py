"""Model definitions of the port: every family of the reference's zoo."""
from .config import (SHAPES, SHAPES_BY_NAME, ModelConfig, MoEConfig,
                     ShapeCell, SsmConfig)
from .transformer import (DecodeLayout, Transformer, cache_pspecs,
                          count_params, decode_step, forward,
                          global_attention_flags, init_cache, init_params,
                          loss_fn, param_pspecs,
                          params_from_jax, params_to_numpy)

__all__ = ["SHAPES", "SHAPES_BY_NAME", "DecodeLayout", "ModelConfig",
           "MoEConfig", "ShapeCell", "SsmConfig", "Transformer",
           "cache_pspecs", "count_params", "decode_step", "forward",
           "global_attention_flags", "init_cache", "init_params",
           "loss_fn", "param_pspecs", "params_from_jax",
           "params_to_numpy"]
