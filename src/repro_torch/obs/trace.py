"""Structured tracing: bounded ring-buffer span/instant events (DESIGN.md §14).

A :class:`Tracer` records events into a bounded per-process ring buffer
(`collections.deque(maxlen=capacity)` — overflow drops the OLDEST events
and counts them, never blocks the hot path).  Timestamps come from
``time.perf_counter_ns()``: the same monotonic clock as
``time.perf_counter()``, so code that already measured a phase with
float ``perf_counter()`` deltas can re-emit the interval exactly via
:meth:`Tracer.complete` with ``int(t * 1e9)``.

Zero-cost-when-disabled is the design contract: every emission site is
guarded by ``tracer.enabled`` (one attribute load + bool test), and the
module-level :data:`NULL_TRACER` singleton answers ``span()`` with a
shared no-op context manager, so disabled tracing adds no allocation,
no lock, no clock read.

Event tuples are ``(ph, name, cat, ts_ns, dur_ns, tid, attrs)`` with
``ph`` the Chrome-trace phase ("X" complete, "i" instant).  ``attrs``
must stay codec-serializable (str/int/float/bool) — host buffers cross
the wire over the ``trace_sync`` control tag.

Categories in use: ``train`` (round/tree/layer/encrypt/...), ``wire``
(one instant per :meth:`Channel.send` ledger append — the audited
category), ``transport`` (framed ship/recv/broker/retry — physical, NOT
audited, so the two views never double count), ``chaos``, ``serve``.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "cat", "tid", "attrs", "start_ns")

    def __init__(self, tracer, name, cat, tid, attrs):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.attrs = attrs

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter_ns() - self.start_ns
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.tracer._emit("X", self.name, self.cat, self.start_ns, dur,
                          self.tid, self.attrs)
        return False


class Tracer:
    """Thread-safe bounded event recorder for one party/process."""

    def __init__(self, party: str = "proc", capacity: int = 1 << 16,
                 enabled: bool = True):
        self.party = party
        self.capacity = capacity
        self.enabled = enabled
        self._events: deque = deque(maxlen=capacity)
        self._emitted = 0
        self._lock = threading.Lock()

    # -- emission -------------------------------------------------------
    def _emit(self, ph, name, cat, ts_ns, dur_ns, tid, attrs):
        if tid is None:
            tid = threading.get_ident() & 0x7FFFFFFF
        with self._lock:
            self._emitted += 1
            self._events.append((ph, name, cat, ts_ns, dur_ns, tid, attrs))

    def span(self, name: str, cat: str = "train", tid=None, **attrs):
        """``with tracer.span("layer", tree=t, depth=d): ...``"""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, tid, attrs)

    def instant(self, name: str, cat: str = "train", tid=None, **attrs):
        if not self.enabled:
            return
        self._emit("i", name, cat, time.perf_counter_ns(), 0, tid, attrs)

    def complete(self, name: str, start_ns: int, dur_ns: int,
                 cat: str = "train", tid=None, **attrs):
        """Emit an already-measured interval (reuses existing
        ``perf_counter()`` floats: pass ``int(t0 * 1e9)``)."""
        if not self.enabled:
            return
        self._emit("X", name, cat, int(start_ns), max(int(dur_ns), 0),
                   tid, attrs)

    # -- introspection --------------------------------------------------
    @property
    def dropped(self) -> int:
        with self._lock:
            return self._emitted - len(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def export_events(self) -> list:
        """Codec-serializable snapshot: list of 7-element lists."""
        with self._lock:
            return [[ph, name, cat, ts, dur, tid, dict(attrs)]
                    for ph, name, cat, ts, dur, tid, attrs in self._events]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._emitted = 0


NULL_TRACER = Tracer(party="null", capacity=1, enabled=False)

# Process-default tracer: emission sites with no Channel in reach (chaos
# endpoints wrap the transport BEFORE the channel exists, fault-layer
# events, benchmark harness).  Per-party attribution everywhere else
# rides on the explicit ``Channel.tracer`` attribute instead, so the
# loopback single-process mode still attributes guest vs host correctly.
_default: Tracer = NULL_TRACER


def set_default(tracer: Tracer) -> Tracer:
    global _default
    prev = _default
    _default = tracer if tracer is not None else NULL_TRACER
    return prev


def current() -> Tracer:
    return _default
