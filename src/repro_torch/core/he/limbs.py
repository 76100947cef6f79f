"""Big unsigned integers as radix-2**8 limbs on int32 torch tensors.

The port of the JAX package's ``core/he/limbs.py``: conversions, carry and
borrow propagation, addition, subtraction, compares, shifts and masks,
the fixed-constant multiply and Barrett reduction by a fixed modulus (what
the plain and affine ciphers and the tree grower use).  A big integer is a
little-endian vector of limbs along the last axis (canonical form: every
limb in [0, 256)); every operation is batched over the leading axes, keeps
the tensor on its device and writes into none of its arguments.

Lazy histogram sums and lazy subtraction leave limbs out of range, some of
them negative.  ``>>`` on an int32 tensor is arithmetic and ``& 255`` is
taken on the two's complement, so ``v == 256 * (v >> 8) + (v & 255)``
holds for a negative limb too, and :func:`carry_fix` reaches the same
canonical form as the reference.  Each step of the loops in
:func:`carry_fix` and :func:`borrow_fix` asks the device whether a limb is
still out of range, one synchronisation per step;
``carry_fix.iterations`` and ``borrow_fix.iterations`` count the steps.

Multiplying by a fixed big integer b is a product with b's Toeplitz limb
matrix (:func:`toeplitz`): :func:`mul_fixed` hands it to
``kernels.modmul.mul_fixed``, the K2 kernel on a CUDA tensor and its plain
version on a CPU tensor.  The JAX package leaves the two products inside
Barrett reduction to XLA as an einsum; the port has no exact integer
matrix product on the card but K2, so they run there too, with the same
result.  The generic schoolbook :func:`mul` multiplies two big integers
exactly in int32 and carries once; the reference's fp32 ``convolve`` is
exact at its widths, and canonical limbs are unique, so both give the
same limbs.
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
        borrow_fix.iterations += 1
    return v


borrow_fix.iterations = 0


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


def compare(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise big-int compare: -1 / 0 / +1 over the leading axes (the
    sign of the most significant limb that differs)."""
    d = torch.sign(a - b)
    L = d.shape[-1]
    # index of the most significant non-zero limb (0 when all are zero,
    # where d is 0 too)
    top = ((d != 0) * torch.arange(L, device=d.device)).amax(dim=-1)
    return d.gather(-1, top.unsqueeze(-1)).squeeze(-1)


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return compare(a, b) >= 0


def cond_sub(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """a mod n given a < 2n (single conditional subtract)."""
    take = geq(a, n).unsqueeze(-1)
    return torch.where(take, sub(a, n.expand_as(a)), a)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


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


def shift_right_bits(a: torch.Tensor, k: int) -> torch.Tensor:
    """floor(a / 2**k) for canonical a (keeps the limb count)."""
    limb_shift, bit_shift = divmod(k, RADIX_BITS)
    x = torch.nn.functional.pad(a, (0, limb_shift))[..., limb_shift:]
    if bit_shift:
        nxt = torch.nn.functional.pad(x, (0, 1))[..., 1:]
        x = (x >> bit_shift) | ((nxt << (RADIX_BITS - bit_shift))
                                & LIMB_MASK)
    return x


def shift_right_limbs(a: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, k))[..., k:]


def mask_bits(a: torch.Tensor, nbits: int) -> torch.Tensor:
    """a mod 2**nbits (keeps the limb count)."""
    full, part = divmod(nbits, RADIX_BITS)
    L = a.shape[-1]
    keep = (torch.arange(L, device=a.device) < full).to(a.dtype)
    out = a * keep
    if part and full < L:
        out[..., full] = a[..., full] & ((1 << part) - 1)
    return out


# ---------------------------------------------------------------------------
# multiplication
# ---------------------------------------------------------------------------

def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched schoolbook multiply of canonical limbs: (..., La) x (...,
    Lb) -> (..., La+Lb) canonical.  Each column sums at most min(La, Lb)
    products below 2**16, exact in int32 while min(La, Lb) < 2**15."""
    La, Lb = a.shape[-1], b.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.zeros(batch + (La + Lb,), dtype=torch.int32, device=a.device)
    for i in range(La):
        out[..., i:i + Lb] += a[..., i:i + 1] * b
    return carry_fix(out)


class DeviceTable:
    """A constant int32 limb table, built once on the host (``host``, a
    numpy array), with one tensor copy per device made at its first use
    and kept (``on``), so a call does not copy it again."""

    def __init__(self, host: np.ndarray):
        self.host = np.ascontiguousarray(host, dtype=np.int32)
        self._copies: dict = {}

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._copies.get(device)
        if t is None:
            t = torch.from_numpy(self.host).to(device)
            self._copies[device] = t
        return t


def toeplitz(b_limbs: np.ndarray, La: int) -> np.ndarray:
    """(La, La+Lb) matrix T with T[i, i+j] = b[j]; then a @ T == a*b limbs."""
    b = np.asarray(b_limbs, dtype=np.int32).reshape(-1)
    Lb = b.shape[0]
    T = np.zeros((La, La + Lb), dtype=np.int32)
    for i in range(La):
        T[i, i:i + Lb] = b
    return T


def mul_fixed(a: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Multiply canonical a (..., La) by the fixed big int behind Toeplitz
    T (La, Lo), a tensor on a's device -> (..., Lo) canonical limbs of
    a*b mod 2**(8*Lo): the K2 kernel on the card, its plain version on
    the CPU.

    Not a second implementation: the one dispatch is
    ``kernels.modmul.ops.mul_fixed``.  This name is kept because the
    JAX package's ``limbs`` has it and Barrett below calls it; the import
    is made at call time because ``kernels.modmul`` imports this module."""
    from ...kernels.modmul.ops import mul_fixed as k2
    return k2(a, T)


# ---------------------------------------------------------------------------
# Barrett reduction by a fixed modulus
# ---------------------------------------------------------------------------

class BarrettCtx:
    """Precomputed tables for reduction mod a fixed n (Ln limbs).

    Valid for inputs x < RADIX**(2*Ln).  ``T_mu`` / ``T_n`` are the
    Toeplitz matrices of mu = floor(RADIX**(2Ln) / n) and of n, sized for
    the operand widths of :func:`barrett_reduce`: (Ln+2, 2Ln+3) each.
    ``n``, ``T_mu`` and ``T_n`` are :class:`DeviceTable` s (numpy on the
    host, one tensor per device)."""

    def __init__(self, n: np.ndarray, T_mu: np.ndarray, T_n: np.ndarray,
                 Ln: int):
        self.n = DeviceTable(n)
        self.T_mu = DeviceTable(T_mu)
        self.T_n = DeviceTable(T_n)
        self.Ln = Ln


def barrett_precompute(n_int: int, Ln: int | None = None) -> BarrettCtx:
    if Ln is None:
        Ln = num_limbs_for_bits(n_int.bit_length())
    mu = (RADIX ** (2 * Ln)) // n_int
    mu_l = from_pyints([mu], Ln + 1)[0]
    n_l = from_pyints([n_int], Ln)[0]
    T_mu = toeplitz(mu_l, Ln + 2)           # q1 has <= Ln+1 limbs; pad to Ln+2
    T_n = toeplitz(np.pad(n_l, (0, 1)), Ln + 2)
    return BarrettCtx(n=n_l, T_mu=T_mu, T_n=T_n, Ln=Ln)


def barrett_reduce(x: torch.Tensor, ctx: BarrettCtx) -> torch.Tensor:
    """x mod n for canonical x with x < RADIX**(2*Ln).  Returns (..., Ln).
    Two K2 products (q1*mu, q3*n), one borrow and two conditional
    subtracts."""
    Ln = ctx.Ln
    L = x.shape[-1]
    if L < 2 * Ln:
        x = torch.nn.functional.pad(x, (0, 2 * Ln - L))
    elif L > 2 * Ln:
        raise ValueError(f"operand too wide for Barrett: {L} > {2 * Ln}")
    dev = x.device
    q1 = shift_right_limbs(x, Ln - 1)[..., : Ln + 2]   # floor(x / b^(Ln-1))
    q2 = mul_fixed(q1, ctx.T_mu.on(dev))               # q1 * mu
    q3 = shift_right_limbs(q2, Ln + 1)[..., : Ln + 2]  # floor(q2 / b^(Ln+1))
    # r = (x - q3*n) mod b^(Ln+1); classic Barrett guarantees 0 <= r < 3n.
    r1 = mask_bits(x[..., : Ln + 2], (Ln + 1) * RADIX_BITS)
    q3n = mask_bits(mul_fixed(q3, ctx.T_n.on(dev))[..., : Ln + 2],
                    (Ln + 1) * RADIX_BITS)
    # t = r1 + b^(Ln+1) - q3n (always >= 0), then drop the top limb to
    # realize the mod-b^(Ln+1) wrap (t is a new tensor: no argument changes)
    t = r1 - q3n
    t[..., Ln + 1] += 1
    r = borrow_fix(t)
    r[..., Ln + 1] = 0
    n_wide = torch.nn.functional.pad(ctx.n.on(dev), (0, 2))
    r = cond_sub(r, n_wide)
    r = cond_sub(r, n_wide)
    return r[..., :Ln]


def mod_mul_fixed(a: torch.Tensor, T_b: torch.Tensor,
                  ctx: BarrettCtx) -> torch.Tensor:
    """(a * b) mod n for canonical a < n and fixed b < n (Toeplitz T_b, a
    tensor on a's device): three K2 products."""
    prod = mul_fixed(a, T_b)[..., : 2 * ctx.Ln]
    return barrett_reduce(prod, ctx)
