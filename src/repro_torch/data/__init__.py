"""Data for the PyTorch port: the paper's synthetic workload generator,
the accuracy tables' surrogate data sets, the trainer's token stream, the
cluster-balanced sampler and the chunked data sources of the out-of-core
paths."""
from .pipeline import ClusterBalancedSampler, doc_sketch
from .source import (ArraySource, DataSource, IterSource, SyntheticSource,
                     as_source, prefetch_to_device)
from .synthetic import (blobs, drifting_blobs, surrogate_iris,
                        surrogate_seeds, token_stream)

__all__ = ["blobs", "drifting_blobs", "surrogate_iris", "surrogate_seeds",
           "token_stream", "ClusterBalancedSampler", "doc_sketch",
           "DataSource", "ArraySource", "IterSource", "SyntheticSource",
           "as_source", "prefetch_to_device"]
