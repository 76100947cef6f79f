"""Public modmul wrappers: the fixed-constant multiply and the modular
multiply, encrypt and decrypt batches built on it.

``mul_fixed`` runs the CUDA kernel (K2) on CUDA tensors and the plain
PyTorch version on CPU tensors.  There is no switch and no fallback:
which version runs follows from the device the tensors lie on, and any
other device raises.  ``mul_fixed.launches`` counts kernel launches, so a
run can show that its path went through the kernel.

Every product with a fixed big integer on the port's paths goes through
``mul_fixed``: the three of each Barrett modular multiply (x*b, q1*mu,
q3*n; ``modmul_fixed``), so each affine encryption and decryption, and the
two of every other Barrett reduction (``core.he.limbs.barrett_reduce``:
the affine cipher's ``reduce`` and ``mul_pow2``).  The shifts, masks,
borrow and conditional subtracts between them are O(L) tensor code.  The
mesh-sharded path of the JAX package waits for ROADMAP M12.
"""

from __future__ import annotations

import torch

from ...analysis.registry import declassifies
from ...core.he import limbs
from .modmul import mul_fixed_cuda
from .ref import mul_fixed_ref


def mul_fixed(x: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """x (..., Lx) canonical limbs times the fixed big int behind T (Lx,
    Lo), int32 tensors on one device -> (..., Lo) canonical limbs of
    x*b mod 2**(8*Lo) on that device."""
    dev = x.device
    if T.device != dev:
        raise ValueError(f"x on {dev}, T on {T.device}")
    if T.dim() != 2 or x.shape[-1] != T.shape[0]:
        raise ValueError(f"mul_fixed needs x (..., Lx) and T (Lx, Lo), got "
                         f"{tuple(x.shape)} and {tuple(T.shape)}")
    x = x.to(torch.int32)
    T = T.to(torch.int32)
    if dev.type == "cpu":
        return mul_fixed_ref(x, T)
    if dev.type != "cuda":
        raise ValueError(f"mul_fixed runs on cuda or cpu, got {dev}")
    flat = x.reshape(-1, x.shape[-1])
    if flat.shape[0] == 0:
        out = torch.zeros((0, T.shape[1]), dtype=torch.int32, device=dev)
    else:
        out = mul_fixed_cuda(flat.contiguous(), T.contiguous())
        mul_fixed.launches += 1
    return out.reshape(x.shape[:-1] + (T.shape[1],))


mul_fixed.launches = 0


# (x * b) mod n for a batch x (..., Ln) of canonical limbs, b fixed
# (Toeplitz T_b on x's device): three ``mul_fixed`` products.  The JAX
# package names this function in both modules (``kernels.modmul`` and
# ``core.he.limbs``), and the parity tests hold each name to its JAX
# counterpart; here the two names are bound to one function object,
# ``limbs.mod_mul_fixed``, not to two implementations.
modmul_fixed = limbs.mod_mul_fixed


@declassifies("kernelized affine encryption: ciphertext limbs only")
def encrypt_batch(cipher, plaintext_limbs: torch.Tensor,
                  out_width: int | None = None) -> torch.Tensor:
    """Affine encryption of a (N, ..., Lp) plaintext limb batch on its
    device -> (N, ..., Ln) ciphertext limbs, or (N, ..., out_width) with
    zero limbs on top when ``out_width`` is wider (ciphertexts born at the
    histogram accumulator width).  Raises ``ValueError`` for a plaintext
    wider than the modulus or a value >= n, which would wrap silently and
    decrypt to garbage (one device sync for the check)."""
    x = plaintext_limbs.to(torch.int32)
    Ln = cipher.Ln
    if x.shape[-1] < Ln:
        x = limbs.pad_limbs(x, Ln)
    elif x.shape[-1] > Ln:
        raise ValueError("plaintext wider than modulus")
    n = cipher.bctx.n.on(x.device)
    if bool(limbs.geq(x, n).any()):
        raise ValueError("plaintext out of range (>= modulus n)")
    out = modmul_fixed(x, cipher.T_enc.on(x.device), cipher.bctx)
    if out_width is not None:
        out = limbs.pad_limbs(out, out_width)
    return out


def decrypt_batch(cipher, ct: torch.Tensor) -> torch.Tensor:
    """Affine decryption of (N, ..., Ln) ciphertext limbs on their device
    -> (N, ..., Ln) plaintext limbs there."""
    x = ct.to(torch.int32)
    return modmul_fixed(x, cipher.T_dec.on(x.device), cipher.bctx)
