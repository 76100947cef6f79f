"""CUDA kernel wrapper: quantile binning (bucketize against per-feature
splits), ``csrc/bucketize.cu``.

Replaces the TPU kernel ``bucketize_pallas`` (``_bucketize_kernel``) of the
JAX package's ``kernels/binning/binning.py``.  The kernel is memory-bound:
8 bytes per element (one fp32 read, one int32 write); its design notes
are in the source.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import load

# the kernel stages the whole (n_f, n_b-1) threshold table in a block's
# shared memory, within the 48 KB a launch gets without an opt-in
MAX_TABLE_BYTES = 48 * 1024


def _lib():
    lib = load("bucketize")
    fn = lib.bucketize_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bucketize_cuda(values: torch.Tensor, thresholds: torch.Tensor
                   ) -> torch.Tensor:
    """Launch the kernel: values (n_i, n_f) fp32, thresholds (n_f, n_t)
    fp32, both contiguous on one CUDA device, n_i * n_f > 0 -> (n_i, n_f)
    int32 on that device.  Raises on any other input or a refused launch;
    does not synchronise."""
    if values.device.type != "cuda" or thresholds.device != values.device:
        raise ValueError(f"bucketize_cuda needs both tensors on one CUDA "
                         f"device, got {values.device} and "
                         f"{thresholds.device}")
    if values.dtype != torch.float32 or thresholds.dtype != torch.float32:
        raise TypeError(f"bucketize_cuda takes float32, got {values.dtype} "
                        f"and {thresholds.dtype}")
    if (values.dim() != 2 or thresholds.dim() != 2
            or thresholds.shape[0] != values.shape[1]):
        raise ValueError(f"bucketize_cuda needs values (n_i, n_f) and "
                         f"thresholds (n_f, n_t), got {tuple(values.shape)} "
                         f"and {tuple(thresholds.shape)}")
    if not (values.is_contiguous() and thresholds.is_contiguous()):
        raise ValueError("bucketize_cuda takes contiguous tensors")
    n_i, n_f = values.shape
    n_t = thresholds.shape[1]
    if n_i * n_f == 0:
        raise ValueError("bucketize_cuda takes a non-empty batch")
    if n_f * n_t * 4 > MAX_TABLE_BYTES:
        raise ValueError(f"threshold table {n_f}x{n_t} exceeds the kernel's "
                         f"{MAX_TABLE_BYTES} bytes of shared memory")
    out = torch.empty((n_i, n_f), dtype=torch.int32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib()(values.data_ptr(), thresholds.data_ptr(),
                    out.data_ptr(), n_i, n_f, n_t, stream)
    if rc != 0:
        raise RuntimeError(f"bucketize kernel launch failed: CUDA error {rc}")
    return out
