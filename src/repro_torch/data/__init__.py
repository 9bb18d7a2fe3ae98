"""Data for the PyTorch port: the paper's synthetic workload generator."""
from .synthetic import blobs

__all__ = ["blobs"]
