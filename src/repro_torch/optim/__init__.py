"""Optimizers of the port."""
from .optimizers import (AdamW, Optimizer, OptState, SgdMomentum, Zero1,
                         lr_schedule, optimizer_state_pspecs)

__all__ = ["AdamW", "OptState", "Optimizer", "SgdMomentum", "Zero1",
           "lr_schedule", "optimizer_state_pspecs"]
