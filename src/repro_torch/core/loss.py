"""Losses and first/second-order derivatives (paper eq 4).

Matches XGBoost conventions: binary logloss (g = p - y, h = p(1-p)) and
softmax cross-entropy for multi-class / multi-output trees (diagonal hessian,
g_k = p_k - y_k, h_k = p_k (1 - p_k)) -- the paper's SBT-MO uses exactly this
diagonal-H form (§5.3.1).

The port keeps its own copy of the JAX package's ``core/loss.py``,
unchanged: this is numpy work on the host in both packages.
"""

from __future__ import annotations

import numpy as np


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.tanh(0.5 * x))


def softmax(x: np.ndarray) -> np.ndarray:
    z = x - x.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


class LogLoss:
    """Binary classification; scores are logits."""
    n_outputs = 1

    @staticmethod
    def init_score(y: np.ndarray) -> float:
        p = np.clip(y.mean(), 1e-6, 1 - 1e-6)
        return float(np.log(p / (1 - p)))

    @staticmethod
    def grad_hess(y: np.ndarray, score: np.ndarray):
        p = sigmoid(score)
        return p - y, np.maximum(p * (1 - p), 1e-16)

    @staticmethod
    def loss(y: np.ndarray, score: np.ndarray) -> float:
        p = np.clip(sigmoid(score), 1e-12, 1 - 1e-12)
        return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


class SoftmaxLoss:
    """Multi-class; scores are (n, k) logits, y integer labels."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.n_outputs = n_classes

    def init_score(self, y: np.ndarray) -> np.ndarray:
        return np.zeros(self.n_classes, dtype=np.float64)

    def grad_hess(self, y: np.ndarray, score: np.ndarray):
        p = softmax(score)                       # (n, k)
        onehot = np.eye(self.n_classes)[y.astype(np.int64)]
        g = p - onehot
        h = np.maximum(p * (1 - p), 1e-16)
        return g, h

    def loss(self, y: np.ndarray, score: np.ndarray) -> float:
        p = np.clip(softmax(score), 1e-12, None)
        return float(-np.log(p[np.arange(len(y)), y.astype(np.int64)]).mean())
