"""Synthetic data (a copy of ``src/repro/data/pipeline.py``)."""
from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
