"""Training-data factory and dataset utilities."""

from .factory import generate_training_data, generate_training_data_streaming

__all__ = ["generate_training_data", "generate_training_data_streaming"]
