"""Identity 'cipher' over limb tensors (the lossless-parity backend).

The port of the JAX package's ``core/he/plain.py``: same dataflow and bit
layout as the affine scheme, but encryption is the identity.  Arithmetic
is mod 2**(8*L).  Ciphertexts are int32 tensors of radix-2**8 limbs on
whatever device they were made on; every operation keeps them there.
"""

from __future__ import annotations

import torch

from ...device import resolve_device
from . import limbs


class PlainCipher:
    backend = "limb"
    name = "plain"

    def __init__(self, bits: int = 512, hist_headroom_limbs: int = 3):
        self.Ln = limbs.num_limbs_for_bits(bits)
        self.plaintext_bits = self.Ln * limbs.RADIX_BITS - 1
        self.hist_headroom_limbs = hist_headroom_limbs

    # -- guest ---------------------------------------------------------
    def encrypt_ints(self, xs, device="cuda") -> torch.Tensor:
        """Python ints as (len(xs), Ln) limbs on ``device`` (a card unless
        ``"cpu"``)."""
        return torch.as_tensor(limbs.from_pyints(list(xs), self.Ln),
                               device=resolve_device(device))

    def encrypt_limbs(self, x: torch.Tensor) -> torch.Tensor:
        return limbs.pad_limbs(x, self.Ln)[..., : self.Ln]

    def decrypt_to_ints(self, ct) -> list:
        return limbs.to_pyints(ct)

    def decrypt_limbs(self, ct: torch.Tensor) -> torch.Tensor:
        return ct

    # -- homomorphic ops ------------------------------------------------
    @staticmethod
    def _align(a, b):
        w = max(a.shape[-1], b.shape[-1])
        return limbs.pad_limbs(a, w), limbs.pad_limbs(b, w)

    def add(self, a, b):
        return limbs.add(*self._align(a, b))

    def sub(self, a, b):
        """Homomorphic a - b (valid when the underlying plaintexts satisfy
        a >= b, which histogram subtraction guarantees)."""
        return limbs.sub(*self._align(a, b))

    def mul_pow2(self, ct, k: int):
        return limbs.mask_bits(
            limbs.shift_left_bits(ct, k, self.hist_width),
            self.hist_width * limbs.RADIX_BITS)

    # -- lazy histogram hooks -------------------------------------------
    @property
    def hist_width(self) -> int:
        return self.Ln + self.hist_headroom_limbs

    def reduce(self, acc):
        """Canonicalize a lazy accumulator (values stay below 2**(8*width)).
        Limbs may be mixed-sign (lazy subtraction) as long as values >= 0."""
        return limbs.carry_fix(acc)

    def lazy_sub(self, parent, child_lazy, count_bound: int):
        """Histogram subtraction in the lazy limb domain: canonical parent
        minus an un-carried child accumulator, still lazy (mixed-sign limbs,
        resolved by the next :meth:`reduce`).  Values are true sums here, so
        ``parent >= child`` holds and no modular offset is needed;
        ``count_bound`` is unused (kept for interface parity with affine)."""
        w = child_lazy.shape[-1]
        return limbs.pad_limbs(parent, w)[..., :w] - child_lazy

    def zero(self, shape, device="cuda") -> torch.Tensor:
        """The zero ciphertext, (*shape, Ln), on ``device`` (a card unless
        ``"cpu"``)."""
        return torch.zeros(tuple(shape) + (self.Ln,), dtype=torch.int32,
                           device=resolve_device(device))
