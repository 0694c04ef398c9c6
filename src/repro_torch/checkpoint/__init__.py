"""Fault-tolerant checkpointing (atomic, retained, restored in place)."""
from .manager import (CheckpointManager, load_train_state, restore_latest,
                      save_checkpoint, train_state_arrays)

__all__ = ["CheckpointManager", "load_train_state", "restore_latest",
           "save_checkpoint", "train_state_arrays"]
