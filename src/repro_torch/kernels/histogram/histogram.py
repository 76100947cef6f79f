"""CUDA kernel wrapper: the layer-batched ciphertext histogram,
``csrc/layer_hist.cu``.

Replaces the TPU kernel ``layer_hist_pallas`` (``_layer_hist_kernel``) of
the JAX package's ``kernels/histogram/histogram.py``.  The kernel is
bound by bytes (each limb row read once, the histogram written once); its
design notes are in the source.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import load


def _lib():
    lib = load("layer_hist")
    fn = lib.layer_hist_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def layer_hist_cuda(bins: torch.Tensor, node_slot: torch.Tensor,
                    cts: torch.Tensor, n_nodes: int,
                    n_bins: int) -> torch.Tensor:
    """Launch the kernel: bins (n_i, n_f), node_slot (n_i,) and cts
    (n_i, W), all int32, contiguous and on one CUDA device, with n_i, n_f,
    W, n_nodes and n_bins > 0 -> (n_nodes, n_f, n_bins, W) int32 lazy sums
    on that device.  Raises on any other input or a refused launch; does
    not synchronise."""
    dev = bins.device
    if dev.type != "cuda" or node_slot.device != dev or cts.device != dev:
        raise ValueError(f"layer_hist_cuda needs three tensors on one CUDA "
                         f"device, got {bins.device}, {node_slot.device} "
                         f"and {cts.device}")
    if not (bins.dtype == node_slot.dtype == cts.dtype == torch.int32):
        raise TypeError(f"layer_hist_cuda takes int32, got {bins.dtype}, "
                        f"{node_slot.dtype} and {cts.dtype}")
    if (bins.dim() != 2 or node_slot.dim() != 1 or cts.dim() != 2
            or node_slot.shape[0] != bins.shape[0]
            or cts.shape[0] != bins.shape[0]):
        raise ValueError(f"layer_hist_cuda needs bins (n_i, n_f), node_slot "
                         f"(n_i,) and cts (n_i, W), got {tuple(bins.shape)}"
                         f", {tuple(node_slot.shape)} and "
                         f"{tuple(cts.shape)}")
    if not (bins.is_contiguous() and node_slot.is_contiguous()
            and cts.is_contiguous()):
        raise ValueError("layer_hist_cuda takes contiguous tensors")
    n_i, n_f = bins.shape
    W = cts.shape[1]
    if min(n_i, n_f, W, n_nodes, n_bins) <= 0:
        raise ValueError(f"layer_hist_cuda takes non-empty shapes, got "
                         f"n_i={n_i} n_f={n_f} W={W} n_nodes={n_nodes} "
                         f"n_bins={n_bins}")
    out = torch.zeros((n_nodes, n_f, n_bins, W), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib()(bins.data_ptr(), node_slot.data_ptr(), cts.data_ptr(),
                    out.data_ptr(), n_i, n_f, n_nodes, n_bins, W, stream)
    if rc != 0:
        raise RuntimeError(f"layer_hist kernel launch failed: CUDA error "
                           f"{rc}")
    return out
