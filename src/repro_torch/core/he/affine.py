"""IterativeAffine-style additively homomorphic cipher over limb tensors.

The port of the JAX package's ``core/he/affine.py``:

    E(x)   = (a * x) mod n          (a random, gcd(a, n) = 1)
    E(x) + E(y) mod n = E(x + y)    additive homomorphism
    s * E(x) mod n    = E(s * x)    scalar homomorphism
    D(c)   = (a^{-1} * c) mod n

``keygen`` draws the same ``(n, a)`` from ``random.Random(seed)`` as the
JAX package, so both encrypt to the same limbs.  Encryption and
decryption are Barrett modular multiplications by a fixed big integer,
one route for both (``kernels.modmul.encrypt_batch`` /
``decrypt_batch``): three products with the K2 kernel on the card.  The
Toeplitz tables ``T_enc``, ``T_dec`` and the Barrett tables are built
once on the host and copied once to each device that uses them.

Security note (as in the JAX package): a known plaintext/ciphertext pair
reveals ``a``; the paper's IterativeAffine has the same symmetric-key
character and was chosen there for speed, with Paillier as the hardened
option.
"""

from __future__ import annotations

import math
import random as _random

import torch

from ...analysis.registry import declassifies
from ...device import resolve_device
from ...kernels import modmul
from . import limbs


class AffineCipher:
    backend = "limb"
    name = "affine"

    def __init__(self, n_int: int, a_int: int, hist_headroom_limbs: int = 3):
        if math.gcd(a_int, n_int) != 1:
            raise ValueError("a must be invertible mod n")
        self.n_int = n_int
        self.a_int = a_int
        self.a_inv_int = pow(a_int, -1, n_int)
        self.Ln = limbs.num_limbs_for_bits(n_int.bit_length())
        self.plaintext_bits = n_int.bit_length() - 1
        self.hist_headroom_limbs = hist_headroom_limbs
        self.bctx = limbs.barrett_precompute(n_int, self.Ln)
        a_l = limbs.from_pyints([a_int], self.Ln)[0]
        ai_l = limbs.from_pyints([self.a_inv_int], self.Ln)[0]
        self.T_enc = limbs.DeviceTable(limbs.toeplitz(a_l, self.Ln))
        self.T_dec = limbs.DeviceTable(limbs.toeplitz(ai_l, self.Ln))

    @classmethod
    def keygen(cls, key_bits: int = 1024, seed: int | None = None,
               hist_headroom_limbs: int = 3) -> "AffineCipher":
        rng = _random.Random(seed)
        while True:
            n = rng.getrandbits(key_bits) | (1 << (key_bits - 1)) | 1
            a = rng.getrandbits(key_bits - 1) | 1
            if math.gcd(a, n) == 1:
                return cls(n, a, hist_headroom_limbs)

    # -- guest ---------------------------------------------------------
    @declassifies("affine-scheme encryption: ciphertext limbs only")
    def encrypt_limbs(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., Lp) plaintext limbs with value < n -> ciphertext
        (..., Ln) on x's device; ``ValueError`` for a value >= n."""
        return modmul.encrypt_batch(self, x)

    @declassifies("affine-scheme encryption: ciphertext limbs only")
    def encrypt_ints(self, xs, device="cuda") -> torch.Tensor:
        """Encrypt python ints on ``device`` (a card unless ``"cpu"``)."""
        return self.encrypt_limbs(torch.as_tensor(
            limbs.from_pyints(list(xs), self.Ln),
            device=resolve_device(device)))

    def decrypt_limbs(self, ct: torch.Tensor) -> torch.Tensor:
        return modmul.decrypt_batch(self, ct)

    def decrypt_to_ints(self, ct: torch.Tensor) -> list:
        return limbs.to_pyints(self.decrypt_limbs(ct))

    # -- homomorphic ops ------------------------------------------------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        pad = torch.nn.functional.pad
        n = pad(self.bctx.n.on(a.device), (0, 1))
        return limbs.cond_sub(limbs.add(pad(a, (0, 1)), pad(b, (0, 1))),
                              n)[..., : self.Ln]

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Homomorphic (a - b) mod n: a + (n - b)."""
        n = self.bctx.n.on(b.device).expand_as(b)
        neg_b = torch.where(limbs.is_zero(b).unsqueeze(-1), b,
                            limbs.sub(n, b))
        return self.add(a, neg_b)

    def mul_pow2(self, ct: torch.Tensor, k: int) -> torch.Tensor:
        """Homomorphic multiply by 2**k (cipher-compress shift)."""
        wide = limbs.shift_left_bits(ct, k, None)
        return self._reduce_wide(wide)

    def _reduce_wide(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] > 2 * self.Ln:
            raise ValueError("operand too wide; reduce more often")
        return limbs.barrett_reduce(x, self.bctx)

    # -- lazy histogram hooks -------------------------------------------
    @property
    def hist_width(self) -> int:
        return self.Ln + self.hist_headroom_limbs

    def reduce(self, acc: torch.Tensor) -> torch.Tensor:
        """Reduce a lazy accumulator (sum of < 2**(8*headroom)
        ciphertexts, ``hist_width`` limbs) to canonical (..., Ln) mod n.
        Limbs may be mixed-sign (lazy subtraction) as long as values >= 0."""
        return limbs.barrett_reduce(limbs.carry_fix(acc), self.bctx)

    def lazy_sub(self, parent: torch.Tensor, child_lazy: torch.Tensor,
                 count_bound: int) -> torch.Tensor:
        """Histogram subtraction in the lazy limb domain: canonical parent
        (mod n) minus an un-carried child accumulator.  The child's lazy
        value can reach ``count_bound * n``, so ``count_bound * n`` is added
        to keep the represented value non-negative; the next :meth:`reduce`
        Barrett-reduces it away (sibling = parent - child mod n).  Requires
        ``(count_bound + 1) * n < RADIX**width``, i.e. count_bound below
        2**(8 * headroom) -- the same bound as direct lazy accumulation."""
        w = child_lazy.shape[-1]
        off = torch.as_tensor(limbs.from_pyints(
            [max(int(count_bound), 0) * self.n_int], w)[0]).to(
                child_lazy.device)
        return limbs.pad_limbs(parent, w)[..., :w] + off - child_lazy

    def zero(self, shape, device="cuda") -> torch.Tensor:
        """The zero ciphertext, (*shape, Ln), on ``device`` (a card unless
        ``"cpu"``)."""
        return torch.zeros(tuple(shape) + (self.Ln,), dtype=torch.int32,
                           device=resolve_device(device))
