"""Model definitions of the port (dense decoder family)."""
from .config import ModelConfig
from .transformer import (Transformer, forward, init_params, loss_fn,
                          params_from_jax, params_to_numpy)

__all__ = ["ModelConfig", "Transformer", "forward", "init_params", "loss_fn",
           "params_from_jax", "params_to_numpy"]
