"""Plain PyTorch version of the quantile-binning (bucketize) kernel."""

from __future__ import annotations

import torch

# smallest normal float32; XLA compares values below it in magnitude as 0
FLT_MIN = torch.finfo(torch.float32).tiny


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """Subnormal floats to zero (NaN and +-inf kept): the JAX reference
    runs under XLA, which flushes subnormal compare operands on the CPU
    and the TPU alike, so ``-1e-45 >= 0`` holds there."""
    return torch.where(x.abs() < FLT_MIN, torch.zeros_like(x), x)


def bucketize_ref(values: torch.Tensor, thresholds: torch.Tensor
                  ) -> torch.Tensor:
    """values (n_i, n_f) fp32, thresholds (n_f, n_b-1) fp32 (+inf padded,
    ascending per feature) -> bin indices (n_i, n_f) int32 in [0, n_b).

    A broadcast ``>=`` count, as the JAX reference: NaN counts 0, +inf
    counts every threshold, subnormals compare as zero.  Not
    ``torch.bucketize`` or ``searchsorted``, whose NaN handling
    differs."""
    ge = flush_denormals(values)[:, :, None] >= \
        flush_denormals(thresholds)[None, :, :]
    return ge.sum(dim=-1).to(torch.int32)
