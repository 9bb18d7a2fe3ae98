"""Run logging: one event schema, a pluggable :class:`RunLogger` hierarchy,
and median-window rates.

The PyTorch port's own copy of the JAX package's stdlib/numpy logger, with
the same event schema, so an event stream from either package reads the
same way.  The one addition: a timer of a real logger synchronises the
CUDA device at its start and end (CUDA launches return before the work is
done), while the :data:`NULL` logger never synchronises — an unlogged fit
runs without a host sync.

Design constraints, in order:

  1. **Zero interference.**  Telemetry is strictly host-side: it never
     touches random generators or tensor values, so a fit with a logger
     attached is bit-for-bit the fit without one.  The default
     :data:`NULL` logger reduces every call to a constant no-op.
  2. **One schema.**  Every emission is a plain dict that round-trips
     through JSON (:func:`validate_event`), so a ``JsonlLogger`` file and a
     ``RecordingLogger`` buffer speak the same vocabulary.
  3. **Median windows for rates.**  Instantaneous step rates are spiky;
     throughput is reported as the median over a sliding window of recent
     steps, so one slow tick does not masquerade as a regression.

Loggers resolve through a registry (``"off"``, ``"memory"``,
``"jsonl[:path]"`` built in; :func:`register_run_logger` adds more), which
is how the declarative ``ExecutionSpec.telemetry`` string stays hashable
and JSON-serializable while still naming a live object at plan time.
"""
from __future__ import annotations

import collections
import contextlib
import json
import time
from typing import Callable, Optional

SCHEMA_VERSION = 1
EVENT_KINDS = ("event", "timer", "rate")

_REQUIRED_KEYS = ("schema", "kind", "name", "t")


def _sync_device() -> None:
    """Wait for queued CUDA work, when this process has touched the card
    (a CPU-only run never initialises CUDA and pays nothing)."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def validate_event(d: dict) -> dict:
    """Check one emitted event against the schema; returns it unchanged.

    Required keys: ``schema`` (int), ``kind`` (one of
    :data:`EVENT_KINDS`), ``name`` (non-empty str), ``t`` (seconds since
    the logger started, float).  Timers additionally carry ``dur`` +
    nesting info (``depth``, ``path``); rates carry ``rate`` + ``units``.
    Everything else lives under ``fields`` (JSON-serializable).
    """
    missing = [k for k in _REQUIRED_KEYS if k not in d]
    if missing:
        raise ValueError(f"telemetry event missing keys {missing}: {d!r}")
    if d["kind"] not in EVENT_KINDS:
        raise ValueError(
            f"telemetry event kind {d['kind']!r} not in {EVENT_KINDS}")
    if not isinstance(d["name"], str) or not d["name"]:
        raise ValueError(f"telemetry event name must be a non-empty str: "
                         f"{d!r}")
    if d["kind"] == "timer" and "dur" not in d:
        raise ValueError(f"timer event missing 'dur': {d!r}")
    if d["kind"] == "rate" and "rate" not in d:
        raise ValueError(f"rate event missing 'rate': {d!r}")
    # the round-trip property the store relies on: plain JSON in and out
    json.dumps(d)
    return d


class MedianWindow:
    """Sliding-window median — the wandblog step-rate idiom.

    ``push(v)`` appends and returns the median of the last ``window``
    values; early on (fewer than ``window`` samples) the median of what has
    been seen so far.  O(window log window) per push, which is noise next
    to any device launch."""

    def __init__(self, window: int = 32):
        if window < 1:
            raise ValueError(f"MedianWindow: window must be >= 1, "
                             f"got {window}")
        self._buf: collections.deque = collections.deque(maxlen=window)

    def push(self, value: float) -> float:
        self._buf.append(float(value))
        return self.median

    @property
    def median(self) -> "float | None":
        if not self._buf:
            return None
        s = sorted(self._buf)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def __len__(self) -> int:
        return len(self._buf)


class RateMeter:
    """Per-step throughput with a median window, bound to a logger.

    ``tick(units)`` times the interval since the previous tick (or an
    explicit ``dur=``), pushes ``units / dur`` into the window, and emits a
    ``rate`` event carrying both the instantaneous and the median-window
    rate.  ``units`` is whatever the caller folds per step — points,
    chunks, tokens."""

    def __init__(self, logger: "RunLogger", name: str, *,
                 units: str = "points", window: int = 32):
        self._logger = logger
        self._name = name
        self._units = units
        self._window = MedianWindow(window)
        self._last: Optional[float] = None
        self._total_units = 0.0
        self._steps = 0

    def tick(self, units: float, *, dur: Optional[float] = None,
             **fields) -> float:
        now = time.perf_counter()
        if dur is None:
            dur = (now - self._last) if self._last is not None else 0.0
        self._last = now
        self._steps += 1
        self._total_units += units
        inst = units / dur if dur > 0 else 0.0
        med = (self._window.push(inst) if dur > 0
               else self._window.median) or 0.0
        payload = dict(rate=med, rate_inst=inst, units=self._units,
                       step=self._steps, step_units=units, dur=dur)
        payload.update(fields)      # caller fields win (e.g. a real step no)
        self._logger._emit(self._logger._make("rate", self._name, **payload))
        return med

    @property
    def total_units(self) -> float:
        return self._total_units

    @property
    def steps(self) -> int:
        return self._steps


class RunLogger:
    """Structured run logger: ``event``/``timer``/``rate`` emissions with
    timer nesting.  Subclasses implement ``_emit(event_dict)``; everything
    else (schema assembly, the nesting stack, relative clocks) is shared.
    """

    def __init__(self):
        self._t0 = time.perf_counter()
        self._stack: list = []   # open timer names, outermost first

    # -- subclass surface -------------------------------------------------
    def _emit(self, event: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    # -- schema assembly --------------------------------------------------
    def _make(self, kind: str, name: str, **extra) -> dict:
        d = {"schema": SCHEMA_VERSION, "kind": kind, "name": name,
             "t": time.perf_counter() - self._t0,
             "depth": len(self._stack),
             "path": "/".join(self._stack + [name])}
        d.update(extra)
        return d

    # -- emission API -----------------------------------------------------
    def event(self, name: str, **fields) -> None:
        self._emit(self._make("event", name, **fields))

    @contextlib.contextmanager
    def timer(self, name: str, **fields):
        """Time a block; nested timers record their ``depth`` and slash
        ``path`` so a trace reconstructs the stage tree.  The CUDA device is
        synchronised at both ends, so ``dur`` is the device work's time,
        not the time to enqueue it."""
        _sync_device()
        start = time.perf_counter()
        self._stack.append(name)
        try:
            yield self
        finally:
            self._stack.pop()
            _sync_device()
            self._emit(self._make("timer", name,
                                  dur=time.perf_counter() - start, **fields))

    def rate(self, name: str, *, units: str = "points",
             window: int = 32) -> RateMeter:
        return RateMeter(self, name, units=units, window=window)


class NullLogger(RunLogger):
    """The default: every call is a constant no-op.  ``timer`` returns a
    shared null context so instrumented hot loops cost one attribute lookup
    when telemetry is off."""

    def _emit(self, event: dict) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass

    def timer(self, name: str, **fields):
        return contextlib.nullcontext(self)

    def rate(self, name: str, *, units: str = "points",
             window: int = 32) -> RateMeter:
        return _NULL_METER


NULL = NullLogger()


class _NullMeter(RateMeter):
    def __init__(self):
        super().__init__(NULL, "null")

    def tick(self, units: float, *, dur: Optional[float] = None,
             **fields) -> float:
        return 0.0


_NULL_METER = _NullMeter()


class RecordingLogger(RunLogger):
    """Collects validated events in ``self.events`` (what the tests and the
    in-process consumers read)."""

    def __init__(self):
        super().__init__()
        self.events: list = []

    def _emit(self, event: dict) -> None:
        self.events.append(validate_event(event))

    def named(self, name: str) -> list:
        return [e for e in self.events if e["name"] == name]


class JsonlLogger(RunLogger):
    """Appends one JSON line per event to ``path`` (the durable spelling —
    long chunked/stream jobs report progress without holding it all)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._fh = open(path, "a")

    def _emit(self, event: dict) -> None:
        self._fh.write(json.dumps(validate_event(event)) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


# ---------------------------------------------------------------------------
# Registry: how the declarative ExecutionSpec.telemetry string becomes a
# live logger at plan time (same shape as the LloydBackend registry)
# ---------------------------------------------------------------------------

_RUN_LOGGERS: dict = {
    "off": lambda arg: NULL,
    "memory": lambda arg: RecordingLogger(),
    "jsonl": lambda arg: JsonlLogger(arg or "repro_run.jsonl"),
}


def register_run_logger(name: str,
                        factory: Callable[[Optional[str]], RunLogger]):
    """Register ``name`` -> factory(arg) so ``ExecutionSpec(telemetry=
    "name[:arg]")`` resolves to a user logger everywhere specs flow."""
    _RUN_LOGGERS[name] = factory


def peak_rss_mb() -> float:
    """Process high-water-mark resident set, MB (``ru_maxrss`` is KB on
    Linux, bytes on macOS)."""
    import resource
    import sys
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return peak / 1024.0 if sys.platform != "darwin" else peak / 2 ** 20


def get_run_logger(spec: "str | RunLogger | None") -> RunLogger:
    """Resolve a telemetry spec: a live :class:`RunLogger` passes through,
    ``None``/``"off"`` is :data:`NULL`, and ``"name[:arg]"`` consults the
    registry (``"jsonl:/tmp/run.jsonl"`` opens that path)."""
    if spec is None:
        return NULL
    if isinstance(spec, RunLogger):
        return spec
    name, _, arg = str(spec).partition(":")
    if name not in _RUN_LOGGERS:
        raise ValueError(
            f"unknown telemetry logger {name!r}; known: "
            f"{sorted(_RUN_LOGGERS)} (register_run_logger adds more)")
    return _RUN_LOGGERS[name](arg or None)
