"""Cipher suites of the port.

The JAX package has three suites behind one surface (``core/he`` there):
``plain`` and ``affine`` over radix-2**8 limb tensors, and the Paillier
oracle over python ints.  The port has ``plain`` so far: the identity
over limbs, which runs the whole protocol (packing, lazy limb
histograms, subtraction, compression, decryption and decoding) with
encryption and decryption the identity.  ``affine`` and ``paillier``
raise until they are ported (ROADMAP Queue 1, slice 3).
"""

from __future__ import annotations


def get_cipher(name: str, **kwargs):
    if name == "plain":
        from .plain import PlainCipher
        return PlainCipher(**kwargs)
    if name in ("affine", "paillier"):
        raise NotImplementedError(
            f"cipher {name!r} is not ported yet (ROADMAP Queue 1: slice 3 "
            f"ports the affine cipher, M2 the Paillier oracle)")
    raise ValueError(f"unknown cipher suite: {name!r}")
