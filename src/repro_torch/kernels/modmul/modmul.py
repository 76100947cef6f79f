"""CUDA kernel wrapper: the fixed-constant limb multiply (K2),
``csrc/mul_fixed.cu``.

Replaces the TPU kernel ``mul_fixed_pallas`` (``_mul_fixed_kernel``) of
the JAX package's ``kernels/modmul/modmul.py``.  Its bound and design
notes are in the source.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import MAX_LX


def _lib():
    lib = load("mul_fixed")
    fn = lib.mul_fixed_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mul_fixed_cuda(x: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x (N, Lx) canonical limbs and T (Lx, Lo), int32,
    contiguous and on one CUDA device, N, Lx and Lo > 0 -> (N, Lo) int32
    canonical limbs of x*b mod 2**(8*Lo) on that device.  Raises on any
    other input, on an Lx whose column sums could pass 2**31, and on a
    refused launch (a row tile past the kernel's shared memory); does not
    synchronise."""
    dev = x.device
    if dev.type != "cuda" or T.device != dev:
        raise ValueError(f"mul_fixed_cuda needs two tensors on one CUDA "
                         f"device, got {x.device} and {T.device}")
    if x.dtype != torch.int32 or T.dtype != torch.int32:
        raise TypeError(f"mul_fixed_cuda takes int32, got {x.dtype} and "
                        f"{T.dtype}")
    if x.dim() != 2 or T.dim() != 2 or x.shape[1] != T.shape[0]:
        raise ValueError(f"mul_fixed_cuda needs x (N, Lx) and T (Lx, Lo), "
                         f"got {tuple(x.shape)} and {tuple(T.shape)}")
    if not (x.is_contiguous() and T.is_contiguous()):
        raise ValueError("mul_fixed_cuda takes contiguous tensors")
    n, Lx = x.shape
    Lo = T.shape[1]
    if min(n, Lx, Lo) <= 0:
        raise ValueError(f"mul_fixed_cuda takes non-empty shapes, got "
                         f"N={n} Lx={Lx} Lo={Lo}")
    if Lx > MAX_LX:
        raise ValueError(f"mul_fixed_cuda takes Lx <= {MAX_LX} limbs (int32 "
                         f"column sums), got {Lx}")
    out = torch.empty((n, Lo), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib()(x.data_ptr(), T.data_ptr(), out.data_ptr(), n, Lx, Lo,
                    stream)
    if rc != 0:
        raise RuntimeError(f"mul_fixed kernel launch failed: CUDA error {rc}")
    return out
