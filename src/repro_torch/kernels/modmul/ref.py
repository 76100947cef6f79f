"""Plain PyTorch version of the fixed-constant multiply kernel (K2)."""

from __future__ import annotations

import torch

from ...core.he import limbs

# the widest x the int32 column sums take: Lx products below 2**16 plus
# the carry into the column stay below 2**31 while Lx * 255 * 256 does
MAX_LX = (2 ** 31 - 1) // (255 * 256)


def mul_fixed_ref(x: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """x (..., Lx) canonical limbs, T (Lx, Lo) Toeplitz of a fixed big int,
    int32 on one device -> (..., Lo) canonical limbs of x*b mod 2**(8*Lo).

    The exact integer product, then :func:`limbs.carry_fix`.  The product
    runs as a float64 ``torch.matmul`` (PyTorch has no int32 matrix product
    on CUDA): every partial sum is an integer below 2**31, far inside
    float64's 2**53, so it is exact and casts back to int32 unchanged."""
    if x.shape[-1] > MAX_LX:
        raise ValueError(f"mul_fixed takes Lx <= {MAX_LX} limbs, got "
                         f"{x.shape[-1]}")
    y = torch.matmul(x.to(torch.float64), T.to(torch.float64))
    return limbs.carry_fix(y.to(torch.int32))
