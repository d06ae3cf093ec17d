"""The synthetic token pipeline of the port (a copy of `repro.data`)."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
