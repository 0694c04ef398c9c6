"""Synthetic data pipelines of the port."""
from .pipeline import (ClassificationTask, MarkovLM, Prefetcher,
                       SyntheticLMStream, make_cluster_task)

__all__ = ["ClassificationTask", "MarkovLM", "Prefetcher",
           "SyntheticLMStream", "make_cluster_task"]
