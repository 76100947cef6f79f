"""CUDA kernel wrappers: the layer- and forest-batched ciphertext
histograms, ``csrc/layer_hist.cu``.

One kernel body with two C entries replaces two TPU kernels of the JAX
package's ``kernels/histogram/histogram.py``: ``layer_hist_pallas``
(``_layer_hist_kernel``, K1) through ``layer_hist_launch``, and
``forest_hist_pallas`` (``_forest_hist_kernel``, K4) through
``forest_hist_launch``, which adds a member-tree axis to the grid; K1 is
its one-member case.  The kernel is bound by bytes (each limb row read
once, the histogram written once); its design notes are in the source.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import load

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> its argument types: bins, node_slot, cts, out, n_i, n_f,
# [k,] n_nodes, n_bins, W, stream
_ARGTYPES = {
    "layer_hist_launch": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                          _P],
    "forest_hist_launch": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                           _I, _P],
}


def _entry(name: str):
    fn = getattr(load("layer_hist"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, bins: torch.Tensor, node_slot: torch.Tensor,
            cts: torch.Tensor, n_nodes: int, n_bins: int) -> torch.Tensor:
    """Check the inputs of either entry (node_slot (n_i,) for K1, (n_i, k)
    for K4), allocate the zeroed output and launch."""
    dev = bins.device
    if dev.type != "cuda" or node_slot.device != dev or cts.device != dev:
        raise ValueError(f"{entry} needs three tensors on one CUDA device, "
                         f"got {bins.device}, {node_slot.device} and "
                         f"{cts.device}")
    if not (bins.dtype == node_slot.dtype == cts.dtype == torch.int32):
        raise TypeError(f"{entry} takes int32, got {bins.dtype}, "
                        f"{node_slot.dtype} and {cts.dtype}")
    forest = entry == "forest_hist_launch"
    if (bins.dim() != 2 or node_slot.dim() != 1 + forest or cts.dim() != 2
            or node_slot.shape[0] != bins.shape[0]
            or cts.shape[0] != bins.shape[0]):
        slot_shape = "(n_i, k)" if forest else "(n_i,)"
        raise ValueError(f"{entry} needs bins (n_i, n_f), node_slot "
                         f"{slot_shape} and cts (n_i, W), got "
                         f"{tuple(bins.shape)}, {tuple(node_slot.shape)} "
                         f"and {tuple(cts.shape)}")
    if not (bins.is_contiguous() and node_slot.is_contiguous()
            and cts.is_contiguous()):
        raise ValueError(f"{entry} takes contiguous tensors")
    n_i, n_f = bins.shape
    W = cts.shape[1]
    k = node_slot.shape[1] if forest else 1
    if min(n_i, n_f, W, k, n_nodes, n_bins) <= 0:
        raise ValueError(f"{entry} takes non-empty shapes, got n_i={n_i} "
                         f"n_f={n_f} W={W} k={k} n_nodes={n_nodes} "
                         f"n_bins={n_bins}")
    shape = (n_nodes, n_f, n_bins, W)
    out = torch.zeros(((k,) + shape) if forest else shape,
                      dtype=torch.int32, device=dev)
    member_arg = (k,) if forest else ()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(entry)(bins.data_ptr(), node_slot.data_ptr(),
                           cts.data_ptr(), out.data_ptr(), n_i, n_f,
                           *member_arg, n_nodes, n_bins, W, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed: CUDA error {rc}")
    return out


def layer_hist_cuda(bins: torch.Tensor, node_slot: torch.Tensor,
                    cts: torch.Tensor, n_nodes: int,
                    n_bins: int) -> torch.Tensor:
    """Launch K1: bins (n_i, n_f), node_slot (n_i,) and cts (n_i, W), all
    int32, contiguous and on one CUDA device, with n_i, n_f, W, n_nodes
    and n_bins > 0 -> (n_nodes, n_f, n_bins, W) int32 lazy sums on that
    device.  Raises on any other input or a refused launch; does not
    synchronise."""
    return _launch("layer_hist_launch", bins, node_slot, cts, n_nodes,
                   n_bins)


def forest_hist_cuda(bins: torch.Tensor, node_slot: torch.Tensor,
                     cts: torch.Tensor, n_nodes: int,
                     n_bins: int) -> torch.Tensor:
    """Launch K4: as :func:`layer_hist_cuda` with node_slot (n_i, k)
    member-local slots, k > 0 -> (k, n_nodes, n_f, n_bins, W) int32 lazy
    sums."""
    return _launch("forest_hist_launch", bins, node_slot, cts, n_nodes,
                   n_bins)
