"""Synthetic data pipelines of the port."""
from .pipeline import MarkovLM, SyntheticLMStream

__all__ = ["MarkovLM", "SyntheticLMStream"]
