"""Quantile binning at serving time: binned features and their thresholds.

``BinnedData`` keeps a party's bin matrix and its thresholds; the
thresholds are uploaded to a device once and cached there, so every
``apply_binning`` (one per party per served batch) reuses the device
copy.  Fitting thresholds and binning the training set come with the
training slice of the port, with the sparse-mode fields.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device, to_device
from ..kernels.binning import bucketize


@dataclasses.dataclass
class BinnedData:
    bins: torch.Tensor          # (n_i, n_f) int32
    thresholds: object          # (n_f, n_b-1) fp32, +inf padded: numpy
                                # array or tensor
    n_bins: int
    _thr_dev: object = dataclasses.field(default=None, repr=False)

    def device_thresholds(self, device: torch.device) -> torch.Tensor:
        """The thresholds as a contiguous fp32 tensor on ``device``,
        uploaded once and cached."""
        if self._thr_dev is None or self._thr_dev.device != device:
            self._thr_dev = to_device(self.thresholds, torch.float32,
                                      device).contiguous()
        return self._thr_dev


def apply_binning(X, binned: BinnedData, device="cuda") -> torch.Tensor:
    """Bin new rows with already-fitted thresholds (inference path):
    ``X`` (n_i, n_f) -> (n_i, n_f) int32 bins on ``device``.  On a card
    this launches the bucketize kernel; the bins stay on the card."""
    dev = resolve_device(device)
    return bucketize(to_device(X, torch.float32, dev),
                     binned.device_thresholds(dev))
