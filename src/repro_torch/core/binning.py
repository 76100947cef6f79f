"""Quantile binning (paper §2.3.1): binned features and their thresholds.

Each party bins its own features once, up front (:func:`bin_features`:
quantile thresholds fitted in numpy, then the bucketize kernel on a card),
and bins new rows at serving time (:func:`apply_binning`).  ``BinnedData``
keeps a party's bin matrix and its thresholds; the thresholds are uploaded
to a device once and cached there, so every ``apply_binning`` (one per
party per served batch) reuses the device copy.  The sparse-aware zero
bin (§6.2) and the out-of-core sketch path are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..kernels.binning import bucketize, fit_quantile_thresholds


@dataclasses.dataclass
class BinnedData:
    bins: object                # (n_i, n_f) int32: a numpy array (training,
                                # where the protocol's row logic reads it)
                                # or a tensor
    thresholds: object          # (n_f, n_b-1) fp32, +inf padded: numpy
                                # array or tensor
    n_bins: int
    _thr_dev: object = dataclasses.field(default=None, repr=False)

    @property
    def n_instances(self) -> int:
        return self.bins.shape[0]

    @property
    def n_features(self) -> int:
        return self.bins.shape[1]

    def device_thresholds(self, device: torch.device) -> torch.Tensor:
        """The thresholds as a contiguous fp32 tensor on ``device``,
        uploaded once and cached."""
        if self._thr_dev is None or self._thr_dev.device != device:
            self._thr_dev = to_device(self.thresholds, torch.float32,
                                      device).contiguous()
        return self._thr_dev


def bin_features(X, n_bins: int = 32, device="cuda") -> BinnedData:
    """Fit quantile thresholds to ``X`` (n_i, n_f) and bin it: on a card the
    bucketize kernel computes the bins, which come back to the host as the
    numpy matrix the protocol's row logic reads."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    thr = fit_quantile_thresholds(X, n_bins)
    binned = BinnedData(bins=None, thresholds=thr, n_bins=n_bins)
    bins = bucketize(to_device(X, torch.float32, dev),
                     binned.device_thresholds(dev))
    binned.bins = bins.cpu().numpy()
    return binned


def apply_binning(X, binned: BinnedData, device="cuda") -> torch.Tensor:
    """Bin new rows with already-fitted thresholds (inference path):
    ``X`` (n_i, n_f) -> (n_i, n_f) int32 bins on ``device``.  On a card
    this launches the bucketize kernel; the bins stay on the card."""
    dev = resolve_device(device)
    return bucketize(to_device(X, torch.float32, dev),
                     binned.device_thresholds(dev))
