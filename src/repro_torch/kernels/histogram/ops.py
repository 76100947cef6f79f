"""Public histogram wrappers.

``ciphertext_histogram`` (K5, one node), ``layer_ciphertext_histogram``
(K1) and ``forest_ciphertext_histogram`` (K4) run the CUDA kernel on CUDA
tensors and the plain PyTorch version on CPU tensors.  There is no switch
and no fallback: which version runs follows from the device the tensors
lie on, and any other device raises.
Each wrapper's ``.launches`` counts its kernel launches, so a run can
show that its path went through the kernel.  The plaintext counts,
``count_histogram`` and ``layer_count_histogram``, are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .histogram import forest_hist_cuda, hist_cuda, layer_hist_cuda
from .ref import forest_hist_ref, hist_ref, layer_hist_ref


def _dispatch(wrapper, ref, cuda, bins, node_slot, cts, lead: tuple,
              *sizes) -> torch.Tensor:
    """The steps every wrapper shares: one device (cpu or cuda), int32
    inputs, the plain version ``ref`` on the CPU, zeros without a launch
    when a shape of the output's leading ``lead`` dims, the rows, the
    features or the limbs is 0, else ``cuda`` and one more count on
    ``wrapper.launches``.  ``node_slot`` is None for K5; ``sizes`` are the
    trailing (n_nodes,) n_bins the ref and the kernel take."""
    named = {k: t for k, t in (("bins", bins), ("node_slot", node_slot),
                               ("cts", cts)) if t is not None}
    dev = cts.device
    if any(t.device != dev for t in named.values()):
        raise ValueError(", ".join(f"{k} on {t.device}"
                                   for k, t in named.items()))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{wrapper.__name__} runs on cuda or cpu, got {dev}")
    tensors = [t.to(torch.int32) for t in named.values()]
    if dev.type == "cpu":
        return ref(*tensors, *sizes)
    (n_i, n_f), W = bins.shape, cts.shape[-1]
    if min(n_i, n_f, W, *lead) == 0:
        return torch.zeros(lead + (n_f, sizes[-1], W), dtype=torch.int32,
                           device=dev)
    out = cuda(*(t.contiguous() for t in tensors), *sizes)
    wrapper.launches += 1
    return out


def ciphertext_histogram(bins: torch.Tensor, cts: torch.Tensor,
                         n_bins: int) -> torch.Tensor:
    """One node's histogram: (n_i, n_f) bins x (n_i, W) limb ciphertexts,
    int32 tensors on one device -> (n_f, n_bins, W) int32 lazy sums on
    that device.  A negative bin (or one >= n_bins) skips the entry; no
    rows give zeros without a launch."""
    return _dispatch(ciphertext_histogram, hist_ref, hist_cuda, bins, None,
                     cts, (), n_bins)


ciphertext_histogram.launches = 0


def layer_ciphertext_histogram(bins: torch.Tensor, node_slot: torch.Tensor,
                               cts: torch.Tensor, n_nodes: int,
                               n_bins: int) -> torch.Tensor:
    """Node-batched histogram for one tree layer: (n_i, n_f) bins x (n_i,)
    node slots x (n_i, W) limb ciphertexts, int32 tensors on one device
    -> (n_nodes, n_f, n_bins, W) int32 lazy sums on that device.  A
    negative bin or slot skips the entry."""
    return _dispatch(layer_ciphertext_histogram, layer_hist_ref,
                     layer_hist_cuda, bins, node_slot, cts, (n_nodes,),
                     n_nodes, n_bins)


layer_ciphertext_histogram.launches = 0


def forest_ciphertext_histogram(bins: torch.Tensor, node_slot: torch.Tensor,
                                cts: torch.Tensor, n_nodes: int,
                                n_bins: int) -> torch.Tensor:
    """(tree, node)-batched histogram for one round-forest layer: (n_i,
    n_f) bins x (n_i, k) member-local node slots x (n_i, W) limb
    ciphertexts, int32 tensors on one device -> (k, n_nodes, n_f, n_bins,
    W) int32 lazy sums on that device.  A negative bin or slot skips the
    entry."""
    return _dispatch(forest_ciphertext_histogram, forest_hist_ref,
                     forest_hist_cuda, bins, node_slot, cts,
                     (node_slot.shape[1], n_nodes), n_nodes, n_bins)


forest_ciphertext_histogram.launches = 0


def count_histogram(bins, n_bins: int) -> np.ndarray:
    """Plaintext per-(feature, bin) instance counts of one node: (n_f,
    n_b) int32, a bin outside [0, n_b) counting nowhere -- the one-node
    case of :func:`layer_count_histogram`."""
    bins = np.asarray(bins)
    return layer_count_histogram(bins, np.zeros(bins.shape[0], np.int64), 1,
                                 n_bins)[0]


def layer_count_histogram(bins, node_slot, n_nodes: int, n_bins: int):
    """Plaintext per-(node, feature, bin) instance counts:
    (n_nodes, n_f, n_b) int32.  Counts never touch the cipher domain, so
    this is a flat numpy bincount over the (feature, node, bin) composite
    index -- O(n_i * n_f) memory, no one-hot materialized.  A bin or slot
    out of range counts nowhere, as the kernels skip it."""
    bins = np.asarray(bins, np.int64)
    slot = np.asarray(node_slot, np.int64)
    n_f = bins.shape[1]
    valid = ((bins >= 0) & (bins < n_bins)
             & ((slot >= 0) & (slot < n_nodes))[:, None])
    flat = (bins + (slot * n_bins)[:, None]
            + np.arange(n_f) * (n_nodes * n_bins))[valid]
    out = np.bincount(flat, minlength=n_f * n_nodes * n_bins)
    return out.astype(np.int32).reshape(n_f, n_nodes,
                                        n_bins).transpose(1, 0, 2)
