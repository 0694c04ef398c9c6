"""Optimizers of the port."""
from .optimizers import AdamW, Optimizer, OptState, SgdMomentum, lr_schedule

__all__ = ["AdamW", "OptState", "Optimizer", "SgdMomentum", "lr_schedule"]
