"""Training and serving runtime of the port."""
from .fault import (FailureInjector, SimulatedFailure, StepTimer,
                    StragglerEvent, StragglerWatchdog)
from .serve import (build_cached_prefill, build_prefill, build_serve_step,
                    serve_shardings)
from .train import (TrainState, Trainer, TrainerConfig, build_train_step,
                    dp_num_workers)

__all__ = ["FailureInjector", "SimulatedFailure", "StepTimer",
           "StragglerEvent", "StragglerWatchdog", "TrainState", "Trainer",
           "TrainerConfig", "build_cached_prefill", "build_prefill",
           "build_serve_step", "build_train_step", "dp_num_workers",
           "serve_shardings"]
