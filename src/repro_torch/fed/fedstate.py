"""Round-granular fault tolerance: the port of ``repro.fed.fedstate``, in
the same on-disk format, so either package resumes the other's
checkpoints.

- ``FedState``: everything a resumed run needs — the array tree (the
  global model, teachers and their Adam states, the current cluster labels
  and centroids, in the JAX package's layout and key paths), the number of
  completed rounds, the running history, the run's fingerprint
  (``fed/driver.py::fingerprint``) and the staleness buffer's entry
  records.
- ``save_round``: one ``round_NNNNN.npz`` + ``.meta.json`` pair a
  checkpointed round under ``ckpt_dir`` (``repro_torch.checkpoint``: the
  npz published last, atomically); history, fingerprint and buffer records
  ride in the meta JSON.  ``keep_last`` prunes older rounds after the new
  one is published.
- ``AsyncCheckpointWriter``: the same save on a worker thread.
- ``restore_run``: the latest round, checked against a template tree and
  against the resuming run's fingerprint; any conflict raises.

Every round is a pure function of (state after the previous round, round
index, seed), and float32 round-trips npz exactly, so a resumed run repeats
the uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import queue
import re
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch import guards, perf

_ROUND_RE = re.compile(r"^round_(\d+)\.npz$")


def json_safe(obj):
    """A deep copy of ``obj`` that ``json.dumps`` takes: tuples as lists,
    numpy values as Python numbers."""
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return json_safe(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


@dataclasses.dataclass
class FedState:
    """Snapshot of a federated run after ``round_index`` completed rounds."""

    round_index: int
    arrays: Any          # tree: {"student": ..., "teachers": ..., ...}
    history: dict        # running history (JSON-safe after json_safe())
    meta: dict = dataclasses.field(default_factory=dict)   # run fingerprint
    # the staleness buffer's entry records (StalenessBuffer.meta(); [] for
    # synchronous runs); the entries' params ride arrays["_async_buffer"]
    buffer_meta: list = dataclasses.field(default_factory=list)


def round_path(ckpt_dir, round_index: int) -> Path:
    return Path(ckpt_dir) / f"round_{round_index:05d}.npz"


def _rounds(ckpt_dir) -> list[int]:
    return sorted(int(m.group(1)) for p in Path(ckpt_dir).iterdir()
                  if (m := _ROUND_RE.match(p.name)))


def latest_round(ckpt_dir) -> Optional[int]:
    """Highest checkpointed round index under ``ckpt_dir``, or None."""
    if not Path(ckpt_dir).is_dir():
        return None
    rounds = _rounds(ckpt_dir)
    return rounds[-1] if rounds else None


def save_round(ckpt_dir, state: FedState, *,
               keep_last: Optional[int] = None) -> Path:
    """Persist one round's state; returns the npz path.  With ``keep_last``
    set, prune all but the newest N rounds AFTER the new one is
    published."""
    path = round_path(ckpt_dir, state.round_index)
    ckpt.save(path, state.arrays, step=state.round_index,
              extra={"history": json_safe(state.history),
                     "fingerprint": json_safe(state.meta),
                     "buffer": json_safe(state.buffer_meta)})
    if keep_last is not None:
        for r in _rounds(ckpt_dir)[:-keep_last]:
            stale = round_path(ckpt_dir, r)
            stale.unlink(missing_ok=True)
            stale.with_suffix(".meta.json").unlink(missing_ok=True)
    return path


class AsyncCheckpointWriter:
    """Background checkpoint writer: the device-to-host copy and the file
    writes leave the round's path.

    - The worker calls the same ``save_round`` (atomic publish), so what
      lands on disk is what the synchronous path writes.
    - ``submit`` blocks once ``max_pending`` snapshots are in flight; none
      is dropped.  One worker publishes them in submission order.
    - ``submit`` deep-copies the mutable JSON members (history, fingerprint,
      buffer records) on the caller's thread.  The tensors are shared by
      reference: the port's updates are functional (every optimizer step,
      merge and scatter makes new tensors), so nothing changes a submitted
      tensor before the worker reads it.
    - A failed write parks its exception, which the next ``submit``,
      ``flush`` or ``close`` raises: a run cannot silently stop
      checkpointing.
    - The worker's write is the ``checkpoint`` span of the round that
      submitted it (``perf.round_token``), and the ``ckpt-submit`` and
      ``ckpt-worker`` jitter points stretch both sides of the handoff."""

    def __init__(self, ckpt_dir, *, keep_last: Optional[int] = None,
                 max_pending: int = 2):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._lock = threading.Lock()     # guards _error across threads
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            guards.jitter_point("ckpt-worker")
            try:
                if item is None:         # close() sentinel
                    return
                state, token = item
                with self._lock:
                    failed = self._error is not None
                if not failed:           # after an error, drain unwritten
                    # runs here, possibly rounds after the submitting round
                    # closed its bucket: the token routes the span back
                    with perf.span("checkpoint", round_id=token):
                        save_round(self.ckpt_dir, state,
                                   keep_last=self.keep_last)
            except BaseException as e:
                with self._lock:
                    self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        with self._lock:
            e, self._error = self._error, None
        if e is not None:
            raise RuntimeError(
                f"async checkpoint writer failed for {self.ckpt_dir!r}"
            ) from e

    def submit(self, state: FedState) -> None:
        """Enqueue one snapshot (blocks when ``max_pending`` are in flight);
        its JSON members are copied here, on the caller's thread."""
        if self._closed:
            raise RuntimeError("submit() after close()")
        self._raise_pending()
        state = dataclasses.replace(
            state, history=json_safe(state.history),
            meta=json_safe(state.meta),
            buffer_meta=json_safe(state.buffer_meta))
        guards.jitter_point("ckpt-submit")
        self._q.put((state, perf.round_token()))

    def flush(self) -> None:
        """Barrier: every submitted snapshot is on disk (or has raised)."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Flush, then stop the worker (idempotent); raises a parked
        writer error."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join()
        self._raise_pending()


def latest_meta(ckpt_dir) -> dict:
    """Meta JSON of the latest round (step, history, fingerprint, buffer):
    the semi-async resume reads it first, for the number of buffered
    params the restore template must carry."""
    r = latest_round(ckpt_dir)
    if r is None:
        raise FileNotFoundError(
            f"no round_*.npz checkpoint under {ckpt_dir!r}")
    return ckpt.load_meta(round_path(ckpt_dir, r))


def restore_run(ckpt_dir, like, *,
                expect_meta: Optional[dict] = None) -> FedState:
    """The latest round under ``ckpt_dir`` in the structure of ``like``
    (CPU tensors); every key of ``expect_meta`` must equal the stored
    fingerprint's, or the resume refuses with the conflicting values."""
    r = latest_round(ckpt_dir)
    if r is None:
        raise FileNotFoundError(
            f"no round_*.npz checkpoint under {ckpt_dir!r}")
    path = round_path(ckpt_dir, r)
    meta = ckpt.load_meta(path)
    fingerprint = meta.get("fingerprint", {})
    if expect_meta:
        want = json_safe(expect_meta)
        conflicts = [f"{k}: checkpoint={fingerprint.get(k)!r} vs "
                     f"this run={v!r}"
                     for k, v in want.items() if fingerprint.get(k) != v]
        if conflicts:
            raise ValueError(
                f"checkpoint {path} was written by a different run "
                "configuration:\n  " + "\n  ".join(conflicts))
    arrays = ckpt.restore(path, like)
    return FedState(round_index=int(meta["step"]), arrays=arrays,
                    history=meta.get("history", {}), meta=fingerprint,
                    buffer_meta=meta.get("buffer", []))
