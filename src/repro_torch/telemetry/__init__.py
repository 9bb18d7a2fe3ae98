"""Structured run telemetry for the PyTorch port: per-stage timers and
throughput meters with the JAX package's event schema.

See :mod:`repro_torch.telemetry.logger` for the schema and the
:class:`RunLogger` hierarchy.
"""
from .logger import (EVENT_KINDS, NULL, SCHEMA_VERSION, JsonlLogger,
                     MedianWindow, NullLogger, RateMeter, RecordingLogger,
                     RunLogger, get_run_logger, peak_rss_mb,
                     register_run_logger, validate_event)

__all__ = [
    "EVENT_KINDS", "NULL", "SCHEMA_VERSION", "JsonlLogger", "MedianWindow",
    "NullLogger", "RateMeter", "RecordingLogger", "RunLogger",
    "get_run_logger", "peak_rss_mb", "register_run_logger",
    "validate_event",
]
