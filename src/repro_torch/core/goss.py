"""Gradient-based One-Side Sampling (paper §6.1, from LightGBM).

Keep the top_rate fraction of instances by |g| (or L2 norm of the gradient
vector for MO trees), uniformly sample other_rate of the rest, and amplify
the small-gradient samples' g/h by (1 - top_rate) / other_rate.

``other_rate <= 0`` means top-only selection: no rest samples, no
amplification.  (Forcing ``n_other = max(1, ...)`` there used to select one
rest sample and amplify it by (1 - top_rate)/1e-12 — a ~1e12x weight that
silently corrupted every g/h sum downstream.)

The port keeps its own copy of the JAX package's ``core/goss.py``,
unchanged: this is numpy work on the host in both packages.
"""

from __future__ import annotations

import numpy as np


def goss_sample(g: np.ndarray, top_rate: float = 0.2, other_rate: float = 0.1,
                rng: np.random.Generator | None = None):
    """Returns (indices, weights): selected instance ids + per-id multiplier."""
    rng = rng or np.random.default_rng(0)
    n = g.shape[0]
    mag = np.abs(g) if g.ndim == 1 else np.linalg.norm(g, axis=-1)
    n_top = max(1, int(round(n * top_rate)))
    n_other = max(1, int(round(n * other_rate))) if other_rate > 0 else 0
    order = np.argsort(-mag, kind="stable")
    top_idx = order[:n_top]
    rest = order[n_top:]
    other_idx = rng.choice(rest, size=min(n_other, len(rest)), replace=False) \
        if n_other and len(rest) else np.empty(0, np.int64)
    amplify = (1.0 - top_rate) / other_rate if other_rate > 0 else 0.0
    idx = np.concatenate([top_idx, other_idx]).astype(np.int64)
    w = np.concatenate([np.ones(len(top_idx)),
                        np.full(len(other_idx), amplify)])
    return idx, w
