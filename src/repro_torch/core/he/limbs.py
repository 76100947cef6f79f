"""Big unsigned integers as radix-2**8 limbs on int32 torch tensors.

The port of the JAX package's ``core/he/limbs.py``, limited to what the
plain cipher and the tree grower use: conversions, carry and borrow
propagation, addition, subtraction, shifts and masks.  A big integer is a
little-endian vector of limbs along the last axis (canonical form: every
limb in [0, 256)); every operation is batched over the leading axes and
keeps the tensor on its device.

Lazy histogram sums and lazy subtraction leave limbs out of range, some of
them negative.  ``>>`` on an int32 tensor is arithmetic and ``& 255`` is
taken on the two's complement, so ``v == 256 * (v >> 8) + (v & 255)``
holds for a negative limb too, and :func:`carry_fix` reaches the same
canonical form as the reference.  Each step of its loop asks the device
whether a limb is still out of range, one synchronisation per step;
``carry_fix.iterations`` counts the steps.  The fixed-constant multiply
and Barrett reduction (the affine cipher) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

RADIX_BITS = 8
RADIX = 1 << RADIX_BITS
LIMB_MASK = RADIX - 1


def num_limbs_for_bits(bits: int) -> int:
    return -(-bits // RADIX_BITS)


# ---------------------------------------------------------------------------
# host-side conversion helpers (numpy / python ints)
# ---------------------------------------------------------------------------

def from_pyints(xs, L: int) -> np.ndarray:
    """Pack an iterable of non-negative python ints into (len(xs), L) limbs."""
    out = np.zeros((len(xs), L), dtype=np.int32)
    for i, x in enumerate(xs):
        if x < 0:
            raise ValueError("limbs are unsigned; got negative value")
        j = 0
        while x and j < L:
            out[i, j] = x & LIMB_MASK
            x >>= RADIX_BITS
            j += 1
        if x:
            raise ValueError(f"value does not fit in {L} limbs")
    return out


def to_pyints(arr) -> list:
    """Inverse of :func:`from_pyints`; accepts any (..., L) canonical array
    or tensor (a tensor is copied to the host first)."""
    if torch.is_tensor(arr):
        arr = arr.cpu().numpy()
    a = np.asarray(arr, dtype=object)
    flat = a.reshape(-1, a.shape[-1])
    out = []
    for row in flat:
        x = 0
        for j in range(len(row) - 1, -1, -1):
            x = (x << RADIX_BITS) | int(row[j])
        out.append(x)
    return out


# ---------------------------------------------------------------------------
# carries / borrows
# ---------------------------------------------------------------------------

def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """Move limb i to position i+1 (drop the overflowing top limb)."""
    out = torch.zeros_like(x)
    out[..., 1:] = x[..., :-1]
    return out


def carry_fix(x: torch.Tensor) -> torch.Tensor:
    """Propagate carries until canonical.  Limbs may be mixed-sign as long
    as the represented value is >= 0 (lazy histogram subtraction).
    Overflow past the last limb is dropped (arithmetic mod RADIX**L)."""
    v = x
    while bool(((v > LIMB_MASK) | (v < 0)).any()):
        v = (v & LIMB_MASK) + _shift_up(v >> RADIX_BITS)
        carry_fix.iterations += 1
    return v


carry_fix.iterations = 0


def borrow_fix(x: torch.Tensor) -> torch.Tensor:
    """Resolve negative limbs (borrow propagation).  Result must be >= 0."""
    v = x
    while bool((v < 0).any()):
        neg = (v < 0).to(v.dtype)
        v = v + neg * RADIX - _shift_up(neg)
    return v


# ---------------------------------------------------------------------------
# basic arithmetic (canonical inputs unless noted)
# ---------------------------------------------------------------------------

def pad_limbs(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the trailing limb axis up to ``width`` (no-op if wider)."""
    L = x.shape[-1]
    if L >= width:
        return x
    return torch.nn.functional.pad(x, (0, width - L))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry_fix(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b, assuming a >= b elementwise as big integers."""
    return borrow_fix(a - b)


# ---------------------------------------------------------------------------
# shifts and masks (static shift amounts)
# ---------------------------------------------------------------------------

def shift_left_bits(a: torch.Tensor, k: int,
                    out_L: int | None = None) -> torch.Tensor:
    limb_shift, bit_shift = divmod(k, RADIX_BITS)
    L = a.shape[-1]
    out_L = out_L if out_L is not None else L + limb_shift + 1
    x = torch.nn.functional.pad(
        a, (limb_shift, max(0, out_L - L - limb_shift)))[..., :out_L]
    if bit_shift:
        x = carry_fix(x << bit_shift)
    return x


def mask_bits(a: torch.Tensor, nbits: int) -> torch.Tensor:
    """a mod 2**nbits (keeps the limb count)."""
    full, part = divmod(nbits, RADIX_BITS)
    L = a.shape[-1]
    keep = (torch.arange(L, device=a.device) < full).to(a.dtype)
    out = a * keep
    if part and full < L:
        out[..., full] = a[..., full] & ((1 << part) - 1)
    return out
