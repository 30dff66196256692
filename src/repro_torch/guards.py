"""Runtime sanitizers for the packed runtime: the torch twin of
``repro.guards``, with the same names, all enabled together by
``FedConfig.guards``.

* compile sentinel — what a recompile means in this port: a kernel library
  built or loaded (``kernels/_build.library``) or a miss in a kernel
  wrapper's per-shape plan cache (``kd_softmax_kl._launch_plan``,
  ``kmeans_assign._launch_plan``, ``fused_merge._merge_plan``).
  ``compile_count()`` sums those misses; ``assert_no_new_compiles`` and
  ``no_new_compiles`` turn "fixed-shape waves never show a kernel a new
  shape after warm-in" into a hard error carrying the delta.  A call that
  finds its plan cached adds nothing.
* ``leak_check()`` — asserts that the live tensors of a device type (CUDA
  by default, found by ``gc``; JAX counts ``jax.live_arrays()``) grow by
  at most ``allow`` across a block: catches per-round buffers pinned
  across rounds (a straggler lane kept as a view keeps its whole (S, ...)
  stack alive as the view's base, which counts too).
* ``no_implicit_transfers()`` — a context manager that does nothing.  JAX
  stages a numpy argument of a jitted program to the device implicitly,
  and its transfer guard turns that into an error; torch has no implicit
  host-to-device staging of that kind (an op mixing a CPU and a CUDA
  tensor raises on its own), so there is nothing to guard.  It is kept so
  the driver's guarded window reads as the JAX one does.
* schedule-jitter race harness — ``enable_jitter(seed)`` arms the
  ``jitter_point(tag)`` calls on every thread-handoff edge of the overlap
  machinery (the stager's prefetch workers and LRU, the async checkpoint
  writer).  Each call sleeps a small DETERMINISTIC duration derived from
  ``(seed, tag, per-tag counter)``, forcing adversarial interleavings
  without randomness across runs; histories must be bitwise identical
  with jitter on and off.  Disarmed, ``jitter_point`` is one lock and one
  comparison.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import threading
import time

import torch


class GuardError(RuntimeError):
    """A runtime invariant (recompile / leak) was violated under guards."""


_lock = threading.Lock()


def _compile_caches():
    """The caches whose misses count as compiles: the kernel library and
    each kernel wrapper's per-shape plan cache."""
    from repro_torch.kernels import (_build, fused_merge, kd_softmax_kl,
                                     kmeans_assign)
    return (_build.library, kd_softmax_kl._launch_plan,
            kmeans_assign._launch_plan, fused_merge._merge_plan)


def install() -> None:
    """Nothing to do: the caches count their misses themselves, so there is
    no listener to register (kept for the JAX package's call sites)."""


def compile_count() -> int:
    """Kernel builds and plan-cache misses so far in this process."""
    return sum(c.cache_info().misses for c in _compile_caches())


def assert_no_new_compiles(baseline: int, context: str = "") -> None:
    current = compile_count()
    if current > baseline:
        where = f" during {context}" if context else ""
        raise GuardError(
            f"compile sentinel: {current - baseline} recompilation(s)"
            f"{where} — the steady state must reuse the warm-in kernels and "
            "plans (a kernel was built or shown a new shape)")


@contextlib.contextmanager
def no_new_compiles(context: str = ""):
    """Assert that no kernel is built or shown a new shape in the block."""
    install()
    baseline = compile_count()
    yield
    assert_no_new_compiles(baseline, context)


@contextlib.contextmanager
def no_implicit_transfers():
    """Does nothing: torch has no implicit host-to-device staging to guard
    (see the module docstring); the guarded window keeps the JAX shape."""
    yield


# ------------------------------------------------------ schedule jitter
_jitter_seed: int | None = None
_jitter_counts: dict[str, int] = {}
_JITTER_MAX_S = 0.02    # longest injected sleep; enough to flip any race


def enable_jitter(seed: int) -> None:
    """Arm the race harness: every ``jitter_point`` sleeps a deterministic
    amount derived from ``(seed, tag, firing index)``."""
    global _jitter_seed
    with _lock:
        _jitter_seed = int(seed)
        _jitter_counts.clear()


def disable_jitter() -> None:
    global _jitter_seed
    with _lock:
        _jitter_seed = None
        _jitter_counts.clear()


def jitter_enabled() -> bool:
    with _lock:
        return _jitter_seed is not None


def jitter_delay(seed: int, tag: str, n: int) -> float:
    """Seconds slept by the ``n``-th firing of ``tag`` under ``seed``:
    0..20 ms chosen by hashing the three."""
    key = f"{seed}:{tag}:{n}".encode()
    h = int.from_bytes(hashlib.blake2b(key, digest_size=4).digest(), "big")
    return (h % 1024) / 1024.0 * _JITTER_MAX_S


def jitter_point(tag: str) -> None:
    """A named thread-handoff edge.  No-op unless ``enable_jitter`` armed
    the harness; armed, it sleeps ``jitter_delay(seed, tag, n)`` for its
    ``n``-th firing — adversarial (every edge stretched differently every
    time) yet exactly reproducible."""
    with _lock:
        if _jitter_seed is None:
            return
        n = _jitter_counts.get(tag, 0)
        _jitter_counts[tag] = n + 1
        seed = _jitter_seed
    time.sleep(jitter_delay(seed, tag, n))


def jitter_counts() -> dict[str, int]:
    """Firings of each tag since the harness was armed (a copy)."""
    with _lock:
        return dict(_jitter_counts)


def _live_tensors(device_type: str) -> int:
    # type(), not isinstance(): a deprecated module proxy found by gc warns
    # when its __class__ is read
    return sum(1 for o in gc.get_objects()
               if issubclass(type(o), torch.Tensor)
               and o.device.type == device_type)


@contextlib.contextmanager
def leak_check(allow: int = 0, context: str = "", *,
               device_type: str = "cuda"):
    """Assert the live tensors on ``device_type`` grow by <= ``allow``
    across the block.  A view keeps its base tensor alive, so a lane kept as
    a view of its (S, ...) stack counts twice."""
    gc.collect()
    before = _live_tensors(device_type)
    yield
    gc.collect()
    grown = _live_tensors(device_type) - before
    if grown > allow:
        where = f" during {context}" if context else ""
        raise GuardError(
            f"leak check: {grown} {device_type} tensor(s) leaked{where} "
            f"(allowed {allow}) — a per-round buffer is being pinned "
            "across rounds")
