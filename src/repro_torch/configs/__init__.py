"""Named workloads for the PyTorch port (the paper's own clustering jobs)."""
from .paper_clustering import COMPRESSION_SWEEP, PAPER_WORKLOADS, workload_spec

__all__ = ["COMPRESSION_SWEEP", "PAPER_WORKLOADS", "workload_spec"]
