"""Observability for the port: the JAX package's jax-free tracing and
metrics modules, kept as the port's own copies (the port imports nothing
of ``repro``).  They back ``core.party.Stats`` and the serving engine's
spans."""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, Series
from .trace import NULL_TRACER, Tracer, current, set_default

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Series",
    "NULL_TRACER", "Tracer", "current", "set_default",
]
