"""Cipher suites of the port.

The JAX package has three suites behind one surface (``core/he`` there):
``plain`` and ``affine`` over radix-2**8 limb tensors, and the Paillier
oracle over python ints.  The port has the two limb suites:

* ``plain``: the identity over limbs, which runs the whole protocol
  (packing, lazy limb histograms, subtraction, compression, decryption
  and decoding) with encryption and decryption the identity;
* ``affine``: ``E(x) = a*x mod n`` with the JAX package's seeded
  ``keygen`` (``get_cipher("affine", key_bits=, seed=)``), its modular
  multiplies on the fixed-constant multiply kernel (K2).

Both expose ``plaintext_bits``, ``backend`` ("limb"), ``Ln``,
``encrypt_ints`` / ``encrypt_limbs``, ``decrypt_limbs`` /
``decrypt_to_ints``, ``add``, ``sub``, ``mul_pow2``
(cipher compress) and the lazy histogram hooks ``hist_width``,
``reduce``, ``lazy_sub`` and ``zero``.  ``paillier`` raises until it is
ported (ROADMAP M2).
"""

from __future__ import annotations


def get_cipher(name: str, **kwargs):
    if name == "plain":
        from .plain import PlainCipher
        return PlainCipher(**kwargs)
    if name == "affine":
        from .affine import AffineCipher
        return AffineCipher.keygen(**kwargs)
    if name == "paillier":
        raise NotImplementedError(
            "cipher 'paillier' is not ported yet (ROADMAP Queue 1 M2, the "
            "Paillier oracle)")
    raise ValueError(f"unknown cipher suite: {name!r}")
