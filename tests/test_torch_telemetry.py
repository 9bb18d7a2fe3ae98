"""The port's measurement helpers (``repro_torch.telemetry``:
``calibrate``, ``summarize_events``) against the JAX package's
(``repro.telemetry``) on the CPU."""
import json
import time

import pytest

from repro.telemetry import calibrate as jax_calibrate
from repro.telemetry import summarize_events as jax_summarize
from repro.telemetry import validate_event as jax_validate
from repro_torch import telemetry
from repro_torch.telemetry import (JsonlLogger, RecordingLogger, calibrate,
                                   summarize_events)


def _stream() -> list:
    """Timers (nested, one name twice), rates, plain events and a
    counter-style event repeated: what a fit's logger records."""
    log = RecordingLogger()
    with log.timer("fit"):
        for i in range(3):
            with log.timer("fold", chunk=i):
                pass
        with log.timer("merge"):
            pass
    meter = log.rate("fold_rate", units="points")
    for i, dur in enumerate((0.5, 0.25, 0.125)):
        meter.tick(1000 * (i + 1), dur=dur)
    for n in (3, 5):
        log.event("pool_flush", rows=n)
    log.event("plan", chunks=3)
    return log.events


def test_summarize_events_matches_the_reference():
    events = _stream()
    for e in events:                      # both packages' schema
        jax_validate(dict(e))
    got, want = summarize_events(events), jax_summarize(events)
    assert got == want
    assert set(got["timers_s"]) == {"fit", "fold", "merge"}
    assert got["event_counts"] == {"fold": 3, "merge": 1, "fit": 1,
                                   "fold_rate": 3, "pool_flush": 2,
                                   "plan": 1}
    assert got["rates"]["fold_rate"] == events[-4]["rate"]
    json.dumps(got)


def test_summarize_events_reads_a_jsonl_file_as_the_reference(tmp_path):
    path = tmp_path / "run.jsonl"
    log = JsonlLogger(str(path))
    for e in _stream():
        log._emit(e)
    log.close()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert summarize_events(events) == jax_summarize(events)
    assert summarize_events([]) == jax_summarize([]) == {
        "timers_s": {}, "rates": {}, "event_counts": {}}


def test_calibrate_is_the_references_probe(monkeypatch):
    """Both packages time the same 2 x 256^3 x 8 FLOPs: on a clock that
    moves 0.5 s a reading, each reports that many FLOPs over 0.5 s; on the
    real clock the port's is positive and finite."""
    ticks = iter(range(1000))
    monkeypatch.setattr(time, "perf_counter", lambda: 0.5 * next(ticks))
    flop = 2 * 256 ** 3 * 8
    assert calibrate() == jax_calibrate() == flop / 0.5 / 1e6
    assert calibrate(repeats=1) == flop / 0.5 / 1e6
    monkeypatch.undo()
    mflops = calibrate()
    assert 0 < mflops < float("inf")


@pytest.mark.parametrize("name", ["calibrate", "summarize_events"])
def test_the_helpers_are_exported(name):
    assert name in telemetry.__all__
    assert getattr(telemetry, name) is getattr(telemetry.logger, name)
