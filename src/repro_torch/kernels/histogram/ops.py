"""Public histogram wrappers.

``layer_ciphertext_histogram`` (K1) and ``forest_ciphertext_histogram``
(K4) run the CUDA kernel on CUDA tensors and the plain PyTorch version on
CPU tensors.  There is no switch and no fallback: which version runs
follows from the device the tensors lie on, and any other device raises.
Each wrapper's ``.launches`` counts its kernel launches, so a run can
show that its path went through the kernel.  ``layer_count_histogram``
(plaintext counts) is numpy, a copy of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from .histogram import forest_hist_cuda, layer_hist_cuda
from .ref import forest_hist_ref, layer_hist_ref


def _common_device(bins, node_slot, cts, name: str) -> torch.device:
    dev = cts.device
    if bins.device != dev or node_slot.device != dev:
        raise ValueError(f"bins on {bins.device}, node_slot on "
                         f"{node_slot.device}, cts on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, got {dev}")
    return dev


def layer_ciphertext_histogram(bins: torch.Tensor, node_slot: torch.Tensor,
                               cts: torch.Tensor, n_nodes: int,
                               n_bins: int) -> torch.Tensor:
    """Node-batched histogram for one tree layer: (n_i, n_f) bins x (n_i,)
    node slots x (n_i, W) limb ciphertexts, int32 tensors on one device
    -> (n_nodes, n_f, n_bins, W) int32 lazy sums on that device.  A
    negative bin or slot skips the entry."""
    dev = _common_device(bins, node_slot, cts, "layer_ciphertext_histogram")
    bins = bins.to(torch.int32)
    node_slot = node_slot.to(torch.int32)
    cts = cts.to(torch.int32)
    if dev.type == "cpu":
        return layer_hist_ref(bins, node_slot, cts, n_nodes, n_bins)
    n_i, n_f = bins.shape
    if min(n_i, n_f, cts.shape[-1], n_nodes) == 0:
        return torch.zeros((n_nodes, n_f, n_bins, cts.shape[-1]),
                           dtype=torch.int32, device=dev)
    out = layer_hist_cuda(bins.contiguous(), node_slot.contiguous(),
                          cts.contiguous(), n_nodes, n_bins)
    layer_ciphertext_histogram.launches += 1
    return out


layer_ciphertext_histogram.launches = 0


def forest_ciphertext_histogram(bins: torch.Tensor, node_slot: torch.Tensor,
                                cts: torch.Tensor, n_nodes: int,
                                n_bins: int) -> torch.Tensor:
    """(tree, node)-batched histogram for one round-forest layer: (n_i,
    n_f) bins x (n_i, k) member-local node slots x (n_i, W) limb
    ciphertexts, int32 tensors on one device -> (k, n_nodes, n_f, n_bins,
    W) int32 lazy sums on that device.  A negative bin or slot skips the
    entry."""
    dev = _common_device(bins, node_slot, cts, "forest_ciphertext_histogram")
    bins = bins.to(torch.int32)
    node_slot = node_slot.to(torch.int32)
    cts = cts.to(torch.int32)
    if dev.type == "cpu":
        return forest_hist_ref(bins, node_slot, cts, n_nodes, n_bins)
    (n_i, n_f), k = bins.shape, node_slot.shape[1]
    if min(n_i, n_f, k, cts.shape[-1], n_nodes) == 0:
        return torch.zeros((k, n_nodes, n_f, n_bins, cts.shape[-1]),
                           dtype=torch.int32, device=dev)
    out = forest_hist_cuda(bins.contiguous(), node_slot.contiguous(),
                           cts.contiguous(), n_nodes, n_bins)
    forest_ciphertext_histogram.launches += 1
    return out


forest_ciphertext_histogram.launches = 0


def layer_count_histogram(bins, node_slot, n_nodes: int, n_bins: int):
    """Plaintext per-(node, feature, bin) instance counts:
    (n_nodes, n_f, n_b) int32.  Counts never touch the cipher domain, so
    this is a flat numpy bincount over the (feature, node, bin) composite
    index -- O(n_i * n_f) memory, no one-hot materialized."""
    bins = np.asarray(bins, np.int64)
    node_slot = np.asarray(node_slot, np.int64)
    n_f = bins.shape[1]
    comp = node_slot[:, None] * n_bins + bins       # (n_i, n_f)
    valid = (node_slot[:, None] >= 0) & (bins >= 0)
    f_idx = np.broadcast_to(np.arange(n_f)[None, :], comp.shape)
    flat = (f_idx * (n_nodes * n_bins) + comp)[valid]
    out = np.bincount(flat, minlength=n_f * n_nodes * n_bins)
    return out.astype(np.int32).reshape(n_f, n_nodes,
                                        n_bins).transpose(1, 0, 2)
