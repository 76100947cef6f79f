"""Public binning wrappers: quantile threshold fitting (numpy, a copy of
the JAX package's) and bucketize, which runs the kernel on a CUDA tensor
and the plain version on a CPU tensor.

There is no switch and no fallback: which version runs follows from the
device the values lie on, and any other device raises.
``bucketize.launches`` counts kernel launches, so a run can show that its
path went through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .binning import bucketize_cuda
from .ref import bucketize_ref


def fit_quantile_thresholds(values: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature quantile split points: (n_f, n_b-1) fp32, +inf padded
    where a feature has fewer distinct quantiles (degenerate features)."""
    v = np.asarray(values, np.float64)
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    thr = np.quantile(v, qs, axis=0).T.astype(np.float32)   # (n_f, n_b-1)
    # collapse duplicate thresholds to +inf so empty bins stay empty
    out = np.full_like(thr, np.inf)
    for f in range(thr.shape[0]):
        uniq = np.unique(thr[f])
        out[f, : len(uniq)] = uniq
    return out


def bucketize(values: torch.Tensor, thresholds: torch.Tensor
              ) -> torch.Tensor:
    """values (n_i, n_f), thresholds (n_f, n_b-1) +inf padded, on one
    device -> (n_i, n_f) int32 bin indices on that device."""
    values = values.to(torch.float32)
    thresholds = thresholds.to(torch.float32)
    if thresholds.device != values.device:
        raise ValueError(f"values on {values.device}, thresholds on "
                         f"{thresholds.device}")
    if values.device.type == "cpu":
        return bucketize_ref(values, thresholds)
    if values.device.type != "cuda":
        raise ValueError(f"bucketize runs on cuda or cpu, got "
                         f"{values.device}")
    if values.numel() == 0:
        return torch.zeros(values.shape, dtype=torch.int32,
                           device=values.device)
    out = bucketize_cuda(values.contiguous(), thresholds.contiguous())
    bucketize.launches += 1
    return out


bucketize.launches = 0
