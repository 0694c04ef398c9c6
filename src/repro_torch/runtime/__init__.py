"""Training and serving runtime of the port."""
from .fault import (FailureInjector, SimulatedFailure, StepTimer,
                    StragglerEvent, StragglerWatchdog)
from .serve import (build_cached_prefill, build_prefill, build_serve_step,
                    serve_shardings)
from .train import Trainer, TrainerConfig

__all__ = ["FailureInjector", "SimulatedFailure", "StepTimer",
           "StragglerEvent", "StragglerWatchdog", "Trainer",
           "TrainerConfig", "build_cached_prefill", "build_prefill",
           "build_serve_step", "serve_shardings"]
