"""Cipher compressing (paper §4.4, Algorithm 4).

The port of the JAX package's ``core/compress.py`` for limb ciphers on one
device.  Hosts pack up to ``eta_s = floor(iota / b_gh)`` split-info
ciphertexts into one by repeated homomorphic shift-and-add:
``e <- e * 2**b_gh + c``.  The guest then performs a single decryption per
package and unpacks ``eta_s`` histogram statistics from the plaintext,
dividing decryption count and transfer bytes by ``eta_s`` (eqs 15-16).
Slot order: the FIRST ciphertext in a group is most significant
(Algorithm 4 shifts the accumulator before each add).
"""

from __future__ import annotations

import numpy as np
import torch


def compress_batch(cipher, cts: torch.Tensor, eta_s: int, b_slot: int):
    """Compress a batch of N limb ciphertexts (N, L) into ceil(N / eta_s)
    packages on the same device.  Returns (packages, group_sizes) where
    group_sizes[i] is how many source ciphertexts package i holds (the last
    group may be short)."""
    if eta_s < 1:
        raise ValueError("eta_s must be >= 1")
    n = cts.shape[0]
    n_groups = -(-n // eta_s)
    sizes = np.full(n_groups, eta_s, dtype=np.int64)
    if n % eta_s:
        sizes[-1] = n % eta_s
    pad = n_groups * eta_s - n
    if pad:
        # E(0) = 0 pads the END of the last group: the pads take the least
        # significant slots, and the guest, told the true group size,
        # unpacks eta_s slots and drops the trailing pad
        cts = torch.cat([cts, cts.new_zeros((pad, cts.shape[-1]))], dim=0)
    groups = cts.reshape(n_groups, eta_s, -1)
    acc = groups[:, 0, :]
    for s in range(1, eta_s):
        acc = cipher.mul_pow2(acc, b_slot)
        acc = cipher.add(acc, groups[:, s, :])
    return acc, sizes


def decompress_ints(plain_ints, sizes, eta_s: int, b_slot: int,
                    padded: bool) -> list:
    """Unpack decrypted package ints back into per-split-info ints.

    ``padded`` says whether short groups were zero-padded to eta_s slots
    (limb backends) or built with their true size (pyobj backend).
    """
    out = []
    mask = (1 << b_slot) - 1
    for x, size in zip(plain_ints, np.asarray(sizes, dtype=np.int64)):
        x = int(x)
        slots_here = eta_s if padded else int(size)
        vals = []
        for _ in range(slots_here):
            vals.append(x & mask)
            x >>= b_slot
        vals.reverse()                  # first ciphertext was most significant
        out.extend(vals[: int(size)])
    return out
