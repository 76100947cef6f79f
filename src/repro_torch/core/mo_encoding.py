"""Multi-class GH packing for SecureBoost-MO (paper §5.3, Algorithms 7 & 8).

For an l-class task, per-instance gradient/hessian *vectors* are packed
``eta_c = floor(iota / b_gh)`` classes per ciphertext, needing
``n_k = ceil(l / eta_c)`` ciphertexts per instance (eqs 21-22).  Within a
ciphertext, earlier classes occupy more significant slots (Algorithm 7 shifts
left before each append); recovery therefore reads slots LSB-first and
reverses (the paper's Algorithm 8 leaves this implicit).

The port keeps its own copy of the JAX package's ``core/mo_encoding.py``,
unchanged: this is numpy work on the host in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import encoding
from .he import limbs


@dataclasses.dataclass(frozen=True)
class MOPackingPlan:
    base: encoding.PackingPlan     # shared b_g / b_h / r / g_off across classes
    n_classes: int

    @property
    def eta_c(self) -> int:
        """Classes per ciphertext (eq 21)."""
        return max(1, self.base.plaintext_bits // self.base.b_gh)

    @property
    def n_k(self) -> int:
        """Ciphertexts per instance (eq 22)."""
        return -(-self.n_classes // self.eta_c)

    def slots_in_ct(self, ct_idx: int) -> int:
        used = min(self.n_classes - ct_idx * self.eta_c, self.eta_c)
        return used

    @property
    def limb_width(self) -> int:
        return limbs.num_limbs_for_bits(self.eta_c * self.base.b_gh)


def plan_mo_packing(G: np.ndarray, H: np.ndarray, n_capacity: int,
                    plaintext_bits: int,
                    r: int = encoding.DEFAULT_PRECISION) -> MOPackingPlan:
    """G, H: (n, l) per-class gradients/hessians."""
    base = encoding.plan_packing(np.asarray(G).ravel(), np.asarray(H).ravel(),
                                 n_capacity, plaintext_bits, r)
    return MOPackingPlan(base=base, n_classes=int(np.asarray(G).shape[1]))


def pack_gh_mo(G: np.ndarray, H: np.ndarray, plan: MOPackingPlan) -> np.ndarray:
    """(n, l) G/H -> (n, n_k, Lp) plaintext limbs (Algorithm 7)."""
    n, l = np.asarray(G).shape
    base = plan.base
    gh = encoding.pack_gh(np.asarray(G).ravel(), np.asarray(H).ravel(),
                          base).reshape(n, l, -1)        # (n, l, Lgh)
    Lp = plan.limb_width
    out = np.zeros((n, plan.n_k, Lp), dtype=np.int64)
    for j in range(l):
        ct_idx, slot = divmod(j, plan.eta_c)
        # Algorithm 7: e <<= b_gh then e += gh_j, so the FIRST class of a
        # ciphertext ends up most significant.  With `used` slots in this
        # ciphertext, class at slot s sits at bit offset (used-1-s)*b_gh.
        used = plan.slots_in_ct(ct_idx)
        off = (used - 1 - slot) * base.b_gh
        shifted = _np_shift_left_bits(gh[:, j, :], off, Lp)
        out[:, ct_idx, :] += shifted
    while np.any(out > limbs.LIMB_MASK):
        carry = out >> limbs.RADIX_BITS
        out &= limbs.LIMB_MASK
        out[..., 1:] += carry[..., :-1]
    return out.astype(np.int32)


def unpack_gh_mo_ints(xs, plan: MOPackingPlan, sample_count: int) -> tuple:
    """Recover per-class (sum g, sum h) from a list of n_k decrypted ints
    (Algorithm 8, with explicit slot-order handling)."""
    base = plan.base
    gs, hs = [], []
    for ct_idx, e in enumerate(xs):
        e = int(e)
        used = plan.slots_in_ct(ct_idx)
        slot_vals = []
        for _ in range(used):
            slot_vals.append(e & ((1 << base.b_gh) - 1))
            e >>= base.b_gh
        for gh in reversed(slot_vals):     # restore class order
            g, h = encoding.unpack_gh_int(gh, base, sample_count)
            gs.append(g)
            hs.append(h)
    return (np.asarray(gs[: plan.n_classes], np.float64),
            np.asarray(hs[: plan.n_classes], np.float64))


def _np_shift_left_bits(a: np.ndarray, k: int, out_L: int) -> np.ndarray:
    """Non-negative limb shift-left by k bits into int64 limbs (lazy carry)."""
    limb_shift, bit_shift = divmod(k, limbs.RADIX_BITS)
    L = a.shape[-1]
    x = np.zeros(a.shape[:-1] + (out_L,), dtype=np.int64)
    take = min(L, out_L - limb_shift)
    if take > 0:
        x[..., limb_shift:limb_shift + take] = a[..., :take]
    if bit_shift:
        x <<= bit_shift        # values < 2**16: caller carry-fixes
    return x
