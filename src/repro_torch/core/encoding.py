"""Fixed-point encoding and GH packing (paper §4.2, Algorithms 3 & 6).

A (g, h) pair is fixed-point encoded (eq 11), g offset to non-negative
(``g_off = |min(g)|``), and packed into one big integer ``gh = g_int << b_h
| h_int`` with bit budgets sized for the worst-case histogram sum over
``n_capacity`` instances (eqs 12-13).  Packing/unpacking is host-side numpy
(runs once per boosting round); the packed plaintext then flows through the
limb-based cipher backends.

Note: Algorithm 6 in the paper writes ``g = gh >> b_g`` -- that is a typo
(the shift must be by ``b_h``, the width of the hessian field); we implement
the correct recovery and verify bit-exactness in tests.

The port keeps its own copy of the JAX package's ``core/encoding.py``,
unchanged: this is numpy work on the host in both packages.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .he import limbs

DEFAULT_PRECISION = 53


@dataclasses.dataclass(frozen=True)
class PackingPlan:
    r: int                # fixed-point fractional bits (eq 11)
    g_off: float          # offset added to every g so encodings are >= 0
    b_g: int              # bits reserved for the g field (eq 13)
    b_h: int              # bits reserved for the h field (eq 13)
    n_capacity: int       # max #instances any histogram sum may contain
    plaintext_bits: int   # iota: usable plaintext width of the cipher

    @property
    def b_gh(self) -> int:
        return self.b_g + self.b_h

    @property
    def limb_width(self) -> int:
        return limbs.num_limbs_for_bits(self.b_gh)

    @property
    def compress_capacity(self) -> int:
        """eta_s = floor(iota / b_gh): split-infos packable per ciphertext."""
        return max(1, self.plaintext_bits // self.b_gh)


def plan_packing(g: np.ndarray, h: np.ndarray, n_capacity: int,
                 plaintext_bits: int, r: int = DEFAULT_PRECISION) -> PackingPlan:
    """Derive bit budgets (eqs 12-13), shrinking r if iota is too small."""
    g = np.asarray(g, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    g_off = float(max(0.0, -float(g.min()))) if g.size else 0.0
    g_max = float(g.max() + g_off) if g.size else 1.0
    h_max = float(max(h.max(), 2.0 ** -r)) if h.size else 1.0
    while True:
        # exact integer bounds on any histogram sum (python ints: no overflow)
        per_g = int(math.floor(g_max * (1 << r))) + 1
        per_h = int(math.floor(h_max * (1 << r))) + 1
        b_g = max(1, (n_capacity * per_g).bit_length())
        b_h = max(1, (n_capacity * per_h).bit_length())
        if b_g + b_h <= plaintext_bits or r <= 4:
            break
        r -= 1
    if b_g + b_h > plaintext_bits:
        raise ValueError(
            f"cannot pack: b_gh={b_g + b_h} > iota={plaintext_bits}")
    return PackingPlan(r=r, g_off=g_off, b_g=b_g, b_h=b_h,
                       n_capacity=n_capacity, plaintext_bits=plaintext_bits)


# ---------------------------------------------------------------------------
# encode (Algorithm 3)
# ---------------------------------------------------------------------------

def encode_int64(x: np.ndarray, r: int) -> np.ndarray:
    """eq 11: round(x * 2**r) as int64 (exact for |x| <= ~2**10 at r=53)."""
    return np.round(np.asarray(x, dtype=np.float64) * float(1 << r)).astype(np.int64)


def _int64_to_limbs(x: np.ndarray, L: int) -> np.ndarray:
    """Non-negative int64 array -> (..., L) radix-2**8 limbs."""
    if np.any(x < 0):
        raise ValueError("negative value in limb conversion")
    shifts = (np.arange(L, dtype=np.int64) * limbs.RADIX_BITS)[None, :]
    return ((x[..., None] >> shifts) & limbs.LIMB_MASK).astype(np.int32)


def pack_gh(g: np.ndarray, h: np.ndarray, plan: PackingPlan) -> np.ndarray:
    """Pack per-instance (g, h) -> (n, Lp) plaintext limbs (Algorithm 3)."""
    g_int = encode_int64(np.asarray(g, np.float64) + plan.g_off, plan.r)
    h_int = encode_int64(h, plan.r)
    Lp = plan.limb_width
    g_l = _int64_to_limbs(g_int, Lp)
    h_l = _int64_to_limbs(h_int, Lp)
    # gh = (g_int << b_h) | h_int, in limb domain (b_h may exceed 63 bits)
    limb_shift, bit_shift = divmod(plan.b_h, limbs.RADIX_BITS)
    g_shifted = np.zeros_like(g_l)
    if bit_shift:
        lo = (g_l.astype(np.int64) << bit_shift) & limbs.LIMB_MASK
        hi = g_l.astype(np.int64) >> (limbs.RADIX_BITS - bit_shift)
        g_shifted_wide = lo
        g_shifted_wide[..., 1:] += hi[..., :-1]
    else:
        g_shifted_wide = g_l.astype(np.int64)
    if limb_shift:
        g_shifted[..., limb_shift:] = g_shifted_wide[..., : Lp - limb_shift]
    else:
        g_shifted = g_shifted_wide
    out = g_shifted.astype(np.int64) + h_l
    while np.any(out > limbs.LIMB_MASK):
        carry = out >> limbs.RADIX_BITS
        out &= limbs.LIMB_MASK
        out[..., 1:] += carry[..., :-1]
    assert np.all(out >= 0) and np.all(out <= limbs.LIMB_MASK)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# decode (Algorithm 6, typo-corrected)
# ---------------------------------------------------------------------------

def unpack_gh_int(x: int, plan: PackingPlan, sample_count: int) -> tuple:
    """Recover (sum g, sum h) floats from one decrypted big int."""
    h_int = x & ((1 << plan.b_h) - 1)
    g_int = x >> plan.b_h          # paper alg 6 says b_g: typo, must be b_h
    scale = float(1 << plan.r)
    g = g_int / scale - plan.g_off * sample_count
    h = h_int / scale
    return g, h


def unpack_gh_ints(xs, plan: PackingPlan, counts) -> tuple:
    gs, hs = [], []
    for x, c in zip(xs, counts):
        g, h = unpack_gh_int(int(x), plan, int(c))
        gs.append(g)
        hs.append(h)
    return np.asarray(gs, np.float64), np.asarray(hs, np.float64)


def limbs_to_float64(arr: np.ndarray) -> np.ndarray:
    """(..., L) limbs -> float64 value (rel. error <= 2**-52; fine for gains)."""
    a = np.asarray(arr, dtype=np.float64)
    w = 256.0 ** np.arange(a.shape[-1])
    return a @ w


def unpack_gh_limbs(arr: np.ndarray, plan: PackingPlan,
                    counts: np.ndarray) -> tuple:
    """Vectorized recovery from decrypted plaintext limbs (numpy, float64).

    Used on the guest after decrypt for the limb backends; exactness within
    float64 is sufficient for gain comparison (bit-exact path: python ints).
    """
    a = np.asarray(arr)
    full, part = divmod(plan.b_h, limbs.RADIX_BITS)
    # h = value mod 2**b_h
    h_l = a.copy()
    if part:
        h_l[..., full] = a[..., full] & ((1 << part) - 1)
        h_l[..., full + 1:] = 0
    else:
        h_l[..., full:] = 0
    h = limbs_to_float64(h_l) / float(1 << plan.r)
    # g = value >> b_h
    g_l = _np_shift_right_bits(a, plan.b_h)
    g = limbs_to_float64(g_l) / float(1 << plan.r)
    g = g - plan.g_off * np.asarray(counts, np.float64)
    return g, h


def _np_shift_right_bits(a: np.ndarray, k: int) -> np.ndarray:
    limb_shift, bit_shift = divmod(k, limbs.RADIX_BITS)
    L = a.shape[-1]
    x = np.zeros_like(a)
    if limb_shift < L:
        x[..., : L - limb_shift] = a[..., limb_shift:]
    if bit_shift:
        nxt = np.zeros_like(x)
        nxt[..., :-1] = x[..., 1:]
        x = (x >> bit_shift) | ((nxt << (limbs.RADIX_BITS - bit_shift))
                                & limbs.LIMB_MASK)
    return x
