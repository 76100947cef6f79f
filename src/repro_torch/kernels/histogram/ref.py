"""Plain PyTorch versions of the ciphertext histogram kernels: one node
(K5), a tree layer (K1) and a round-forest layer (K4)."""

from __future__ import annotations

import torch


def layer_hist_ref(bins: torch.Tensor, node_slot: torch.Tensor,
                   cts: torch.Tensor, n_nodes: int,
                   n_bins: int) -> torch.Tensor:
    """Node-batched ciphertext histogram (one tree layer).

    bins:      (n_i, n_f) int32 bin per (instance, feature).
    node_slot: (n_i,) int32 frontier-node slot of each instance.
    cts:       (n_i, W) int32 limb vectors.
    returns (n_nodes, n_f, n_bins, W) int32 lazy (un-carried) limb sums.

    A row counts for feature f only when ``0 <= node_slot < n_nodes`` and
    ``0 <= bins[:, f] < n_bins`` (a negative slot or bin is the protocol's
    mask).  The sums are exact int32 scatter-adds over the composite index
    ``(node_slot * n_f + f) * n_bins + bin``, one feature at a time, so
    they stay exact at any row count (the JAX reference's fp32 one-hot
    einsum is exact only while each sum stays below 2**24)."""
    n_i, n_f = bins.shape
    W = cts.shape[-1]
    out = torch.zeros((n_nodes * n_f * n_bins, W), dtype=torch.int32,
                      device=cts.device)
    slot = node_slot.to(torch.int64)
    slot_ok = (slot >= 0) & (slot < n_nodes)
    for f in range(n_f):
        b = bins[:, f].to(torch.int64)
        ok = slot_ok & (b >= 0) & (b < n_bins)
        idx = (slot * n_f + f) * n_bins + b
        out.index_add_(0, idx[ok], cts[ok])
    return out.view(n_nodes, n_f, n_bins, W)


def forest_hist_ref(bins: torch.Tensor, node_slot: torch.Tensor,
                    cts: torch.Tensor, n_nodes: int,
                    n_bins: int) -> torch.Tensor:
    """(tree, node)-batched ciphertext histogram (one round-forest layer).

    node_slot: (n_i, k) int32 member-local slots, one column per member
    tree of the round (negative: the row is in no direct node of that
    member).  Returns (k, n_nodes, n_f, n_bins, W) int32 lazy sums: for
    each member column, :func:`layer_hist_ref`'s exact int32 scatter-adds
    (the JAX reference's fp32 einsum is exact only below 2**24)."""
    return torch.stack([layer_hist_ref(bins, node_slot[:, t], cts, n_nodes,
                                       n_bins)
                        for t in range(node_slot.shape[1])])


def hist_ref(bins: torch.Tensor, cts: torch.Tensor,
             n_bins: int) -> torch.Tensor:
    """One node's ciphertext histogram.

    bins: (n_i, n_f) int32 bin per (instance, feature).
    cts:  (n_i, W) int32 limb vectors.
    returns (n_f, n_bins, W) int32 lazy (un-carried) limb sums.

    A row counts for feature f only when ``0 <= bins[:, f] < n_bins`` (a
    negative bin is the protocol's mask).  :func:`layer_hist_ref` with
    every row in node 0: exact int32 scatter-adds, one feature at a time,
    at any row count (the JAX reference's fp32 one-hot einsum is exact
    only while each sum stays below 2**24)."""
    slot = torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)
    return layer_hist_ref(bins, slot, cts, 1, n_bins)[0]
