"""Metrics registry: counter / gauge / histogram / series instruments.

The registry backs :class:`repro_torch.core.party.Stats`: the timing fields
that used to be hand-threaded float/list dataclass fields now live here
as instruments, and ``Stats`` reads them back through generated
properties — so ``stats.encrypt_seconds += dt`` and
``stats.layer_overlap.append(x)`` keep working verbatim while new
instruments (per-tag RTT histograms, broker queue depth, retry counts)
register themselves on first touch.

Instruments are deliberately tiny:

* :class:`Counter` — monotone-ish accumulator (``add``; ``set`` exists
  so merge/rollback code can overwrite).  Merge semantics: add.
* :class:`Gauge`   — high-water mark (``observe`` keeps the max).
* :class:`Histogram` — count/sum/min/max under a lock (a compound
  update; the only instrument that needs one).
* :class:`Series`  — a plain list exposed as ``.data`` so existing
  ``append`` / ``extend`` / ``del lst[t:]`` call sites keep their exact
  behavior (including replay rollback).  Merge semantics: concat.

``snapshot()`` returns a codec-serializable nested dict for the
``status`` control tag and ``--json`` bench output.
"""

from __future__ import annotations

import math
import threading


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def add(self, v: float = 1.0) -> None:
        self.value += v

    def set(self, v: float) -> None:
        self.value = float(v)


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def observe(self, v: float) -> None:
        if v > self.value:
            self.value = float(v)

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    __slots__ = ("count", "total", "min", "max", "_lock")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def snapshot(self) -> dict:
        with self._lock:
            if not self.count:
                return {"count": 0, "sum": 0.0}
            return {"count": self.count, "sum": self.total,
                    "min": self.min, "max": self.max,
                    "mean": self.total / self.count}


class Series:
    __slots__ = ("data",)

    def __init__(self):
        self.data: list = []


class MetricsRegistry:
    """Get-or-create instrument registry, thread-safe on creation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}
        self._series: dict = {}

    def _get(self, table: dict, name: str, cls):
        inst = table.get(name)
        if inst is None:
            with self._lock:
                inst = table.setdefault(name, cls())
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def series(self, name: str) -> Series:
        return self._get(self._series, name, Series)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.snapshot()
                               for k, h in self._histograms.items()},
                "series": {k: list(s.data) for k, s in self._series.items()},
            }

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._series.clear()
