"""Synthetic tabular data for the port's training runs.

The port's copy of ``synthetic_tabular`` from the JAX package's
``data/pipeline.py``, unchanged (numpy), so a run on the card builds the
same rows from the same seed as the JAX package does.
"""

from __future__ import annotations

import numpy as np


def synthetic_tabular(n: int, d: int, seed: int = 0, task: str = "binary",
                      n_classes: int = 2, sparsity: float = 0.0):
    """Synthetic vertical-federated tabular data with a nonlinear target."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    if sparsity:
        X[rng.random(X.shape) < sparsity] = 0.0
    w = rng.normal(0, 1, d)
    s = X @ w + 0.5 * (X[:, 0] * X[:, min(1, d - 1)]) \
        + 0.3 * rng.normal(0, 1, n)
    if task == "binary":
        y = (s > np.median(s)).astype(np.float64)
    else:
        qs = np.quantile(s, np.linspace(0, 1, n_classes + 1)[1:-1])
        y = np.digitize(s, qs).astype(np.float64)
    return X, y
