"""Data for the PyTorch port: the paper's synthetic workload generator,
the trainer's token stream and the chunked data sources of the out-of-core
paths."""
from .source import (ArraySource, DataSource, IterSource, SyntheticSource,
                     as_source, prefetch_to_device)
from .synthetic import blobs, drifting_blobs, token_stream

__all__ = ["blobs", "drifting_blobs", "token_stream", "DataSource",
           "ArraySource", "IterSource", "SyntheticSource", "as_source",
           "prefetch_to_device"]
