"""Training runtime of the port."""
from .train import Trainer

__all__ = ["Trainer"]
