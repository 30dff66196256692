"""Per-phase wall-clock instrumentation for the round hot path: the port's
copy of ``repro.perf`` (pure Python).

A process-global, explicitly enabled phase timer whose ``span`` contexts
cost one attribute read when disabled, so runs that do not ask pay
nothing.  The driver and the packed strategies are instrumented:

    from repro_torch import perf
    perf.enable()
    run_federated(ds, cfg, device="cuda")
    rounds = perf.snapshot()     # [{"stage": s, "compute": s, ...}, ...]
    perf.disable()

Contract:

- ``span(name)`` accumulates wall-clock into the CURRENT round's bucket;
  nested/repeated spans of the same name add up.  When disabled it is a
  no-op.
- ``end_round()`` closes the current bucket and appends it to the per-round
  list; the driver calls it once per completed round (set-up and warm-up
  land in the first bucket, which also carries the kernels' first build).
- Thread attribution: work that RUNS on a background thread but BELONGS to
  a round (the async checkpoint writer's device-to-host copy and npz
  write) is recorded with ``span(name, round_id=token)``, the token taken
  on the submitting thread with ``round_token()``.  Such a span lands in
  its submission round's bucket even when that bucket is already closed.
- Timings NEVER enter the run history or the checkpoint.

Spans measure host wall-clock.  CUDA work is queued asynchronously, so a
span that only queues device work hands the wait to whichever later span
blocks; the packed strategies read each wave's losses inside their
``compute`` span, which keeps the attribution honest.
"""
from __future__ import annotations

import contextlib
import threading
import time

_lock = threading.Lock()
_enabled = False
_current: dict[str, float] = {}
_rounds: list[dict[str, float]] = []


def enable() -> None:
    """Start collecting (clears any previous collection)."""
    global _enabled
    with _lock:
        _enabled = True
        _current.clear()
        _rounds.clear()


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def round_token() -> int:
    """Token naming the round bucket currently open on the caller's thread.

    Capture it where the work is SUBMITTED, pass it to ``span(...,
    round_id=token)`` where the work RUNS: the span then lands in this
    bucket no matter which thread executes it or how many rounds have
    closed in between."""
    with _lock:
        return len(_rounds)


@contextlib.contextmanager
def span(name: str, round_id: int | None = None):
    """Accumulate wall-clock under ``name``.

    Without ``round_id``: into the round bucket open at EXIT time (the
    driver-thread pattern).  With ``round_id`` (a ``round_token()``
    capture): into that specific round's bucket, open or closed."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            if round_id is None or round_id >= len(_rounds):
                bucket = _current
            else:
                bucket = _rounds[round_id]
            bucket[name] = bucket.get(name, 0.0) + dt


def add(name: str, dt: float, round_id: int | None = None) -> None:
    """Accumulate a pre-measured duration under ``name`` — the non-context
    form of ``span`` for durations measured elsewhere (e.g. the WaveStager's
    background gather time, measured on the feeder thread but ATTRIBUTED at
    adoption time on the driver thread).  Bucket selection matches ``span``:
    the open bucket without ``round_id``, the named round's bucket with."""
    if not _enabled:
        return
    with _lock:
        if round_id is None or round_id >= len(_rounds):
            bucket = _current
        else:
            bucket = _rounds[round_id]
        bucket[name] = bucket.get(name, 0.0) + float(dt)


def end_round() -> None:
    """Close the current round's bucket (driver: once per completed round)."""
    if not _enabled:
        return
    with _lock:
        _rounds.append(dict(_current))
        _current.clear()


def snapshot() -> list[dict[str, float]]:
    """Per-round phase buckets collected since ``enable()`` (a copy).

    Late token-attributed spans (an async checkpoint still in flight)
    patch the live buckets, not this copy — flush background writers
    before snapshotting."""
    with _lock:
        return [dict(r) for r in _rounds]
