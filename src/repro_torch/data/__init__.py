"""Synthetic data pipelines of the port."""
from .pipeline import (ClassificationTask, FramesStream, MarkovLM,
                       Prefetcher, SyntheticLMStream, make_cluster_task)

__all__ = ["ClassificationTask", "FramesStream", "MarkovLM", "Prefetcher",
           "SyntheticLMStream", "make_cluster_task"]
