"""Declared privacy contracts used by the port's production code.

Pure data plus one decorator: :func:`declassifies` marks a sanitizer and
:data:`SECRET_FIELD_NAMES` is what the serving export audit refuses to
write.  The values are those of the JAX package's registry.
"""

from __future__ import annotations


def declassifies(reason: str):
    """Declare a function a *sanitizer*: its result is no longer secret.

    ``reason`` documents WHY the output is safe to disclose (encryption,
    an aggregate the protocol reveals by design, one-bit packing).
    """
    def deco(fn):
        fn.__declassifies__ = reason
        return fn
    return deco


# Private-key material (Paillier, then the affine symmetric key).
SECRET_KEY_ATTRS = frozenset({
    "_lam", "_mu",
    "T_dec", "T_enc", "a_int", "a_inv_int",
})

# Field names that must never appear as an array or manifest key in ANY
# per-party export: plaintext gradients/labels and private-key material.
SECRET_FIELD_NAMES = frozenset({
    "g", "h", "g_sel", "h_sel", "y", "labels", "gh", "grad", "hess",
}) | SECRET_KEY_ATTRS
