"""Training runtime of the port."""
from .fault import (FailureInjector, SimulatedFailure, StepTimer,
                    StragglerEvent, StragglerWatchdog)
from .train import Trainer, TrainerConfig

__all__ = ["FailureInjector", "SimulatedFailure", "StepTimer",
           "StragglerEvent", "StragglerWatchdog", "Trainer",
           "TrainerConfig"]
