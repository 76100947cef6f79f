"""CUDA kernel wrappers: the layer-, forest- and node-level ciphertext
histograms, ``csrc/layer_hist.cu``.

One kernel body with three C entries replaces three TPU kernels of the
JAX package's ``kernels/histogram/histogram.py``: ``layer_hist_pallas``
(``_layer_hist_kernel``, K1) through ``layer_hist_launch``,
``forest_hist_pallas`` (``_forest_hist_kernel``, K4) through
``forest_hist_launch``, which adds a member-tree axis to the grid (K1 is
its one-member case), and ``hist_pallas`` (``_hist_kernel``, K5) through
``node_hist_launch``, K1 with one node and no slot vector.  The kernel is
bound by bytes (each limb row read once, the histogram written once); its
design notes are in the source.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import load

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> its argument types: bins, [node_slot,] cts, out, n_i, n_f,
# [k,] [n_nodes,] n_bins, W, stream
_ARGTYPES = {
    "layer_hist_launch": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                          _P],
    "forest_hist_launch": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                           _I, _P],
    "node_hist_launch": [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P],
}
# C entry -> the dimensions of its node_slot (None: it takes no slots)
_SLOT_DIM = {"layer_hist_launch": 1, "forest_hist_launch": 2,
             "node_hist_launch": None}


def _entry(name: str):
    fn = getattr(load("layer_hist"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, bins: torch.Tensor, node_slot, cts: torch.Tensor,
            n_nodes: int, n_bins: int) -> torch.Tensor:
    """Check the inputs of any entry (node_slot (n_i,) for K1, (n_i, k)
    for K4, None for K5), allocate the zeroed output and launch."""
    slot_dim = _SLOT_DIM[entry]
    tensors = (bins, cts) if slot_dim is None else (bins, node_slot, cts)
    dev = bins.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{entry} needs its tensors on one CUDA device, "
                         f"got " + ", ".join(str(t.device) for t in tensors))
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError(f"{entry} takes int32, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if (bins.dim() != 2 or cts.dim() != 2 or cts.shape[0] != bins.shape[0]
            or (slot_dim is not None
                and (node_slot.dim() != slot_dim
                     or node_slot.shape[0] != bins.shape[0]))):
        slot_shape = {1: " node_slot (n_i,),", 2: " node_slot (n_i, k),",
                      None: ""}[slot_dim]
        raise ValueError(f"{entry} needs bins (n_i, n_f),{slot_shape} cts "
                         f"(n_i, W), got "
                         + ", ".join(str(tuple(t.shape)) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{entry} takes contiguous tensors")
    n_i, n_f = bins.shape
    W = cts.shape[1]
    k = node_slot.shape[1] if slot_dim == 2 else 1
    if min(n_i, n_f, W, k, n_nodes, n_bins) <= 0:
        raise ValueError(f"{entry} takes non-empty shapes, got n_i={n_i} "
                         f"n_f={n_f} W={W} k={k} n_nodes={n_nodes} "
                         f"n_bins={n_bins}")
    shape = {1: (n_nodes, n_f, n_bins, W), 2: (k, n_nodes, n_f, n_bins, W),
             None: (n_f, n_bins, W)}[slot_dim]
    out = torch.zeros(shape, dtype=torch.int32, device=dev)
    # the C entry's order: the inputs' and the output's pointers, n_i, n_f,
    # then k (K4 only) and n_nodes (K1 and K4), then n_bins, W, stream
    args = [t.data_ptr() for t in tensors] + [out.data_ptr(), n_i, n_f]
    if slot_dim == 2:
        args.append(k)
    if slot_dim is not None:
        args.append(n_nodes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(entry)(*args, n_bins, W, stream)
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


def hist_cuda(bins: torch.Tensor, cts: torch.Tensor,
              n_bins: int) -> torch.Tensor:
    """Launch K5, one node's histogram: bins (n_i, n_f) and cts (n_i, W),
    int32, contiguous and on one CUDA device, with n_i, n_f, W and n_bins
    > 0 -> (n_f, n_bins, W) int32 lazy sums on that device.  Raises on any
    other input or a refused launch; does not synchronise."""
    return _launch("node_hist_launch", bins, None, cts, 1, n_bins)
