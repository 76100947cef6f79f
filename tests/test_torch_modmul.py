"""The port's fixed-constant multiply (K2's plain version) and the modular
multiply, encrypt and decrypt batches built on it, against the JAX
package, on the CPU.

On a CPU tensor ``mul_fixed`` takes the plain version, which must equal
the JAX Pallas kernel ``mul_fixed_pallas`` (interpret mode, as
``tests/test_kernels.py`` runs it) and the JAX reference bit for bit: the
``tests/test_kernels.py`` sweep (64/128/256-bit operands, 1/7/100 rows),
the 1024-bit encrypt and Barrett shapes at a few hundred rows, all-255
inputs (the largest column sums and longest carry chains), zeros, and an
output narrower than the full product (the wrap mod 2**(8*Lo)).
``modmul_fixed``, ``encrypt_batch`` and ``decrypt_batch`` must give the
JAX package's limbs and python ints' ``(v * b) % n``.  Limb arithmetic is
exact, so there is no tolerance.  The CUDA kernel itself is held to the
same plain version on the card by ``chip_smoke.py``.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.he import get_cipher as jax_get_cipher
from repro.core.he import limbs as jl
from repro.kernels.modmul import decrypt_batch as jax_decrypt_batch
from repro.kernels.modmul import encrypt_batch as jax_encrypt_batch
from repro.kernels.modmul import modmul_fixed as jax_modmul_fixed
from repro.kernels.modmul.modmul import mul_fixed_pallas
from repro.kernels.modmul.ref import mul_fixed_ref as jax_mul_fixed_ref

from repro_torch.core.he import get_cipher
from repro_torch.core.he import limbs as tl
from repro_torch.kernels.modmul import (decrypt_batch, encrypt_batch,
                                        modmul_fixed, mul_fixed,
                                        mul_fixed_ref)
from repro_torch.kernels.modmul.modmul import mul_fixed_cuda
from repro_torch.kernels.modmul.ref import MAX_LX

torch.set_num_threads(1)


def _check_mul(x: np.ndarray, T: np.ndarray) -> np.ndarray:
    """The port's plain version and dispatch against the JAX kernel
    (interpret mode) and reference; returns the product limbs."""
    pallas = np.asarray(mul_fixed_pallas(jnp.asarray(x), jnp.asarray(T),
                                         interpret=True))
    ref = np.asarray(jax_mul_fixed_ref(jnp.asarray(x), jnp.asarray(T)))
    np.testing.assert_array_equal(pallas, ref)
    xt, Tt = torch.from_numpy(x), torch.from_numpy(T)
    got = mul_fixed(xt, Tt)
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], T.shape[1])
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert torch.equal(mul_fixed_ref(xt, Tt), got)
    return pallas


def _product_ints(x, b_int, Lo):
    return [(v * b_int) % (1 << (8 * Lo)) for v in tl.to_pyints(x)]


@pytest.mark.parametrize("bits", [64, 128, 256])
@pytest.mark.parametrize("batch", [1, 7, 100])
def test_mul_fixed_plain_equals_jax_kernel_sweep(bits, batch):
    # the operands of tests/test_kernels.py::test_modmul_kernel
    rnd = random.Random(bits + batch)
    n_int = rnd.getrandbits(bits) | (1 << (bits - 1)) | 1
    Ln = jl.num_limbs_for_bits(n_int.bit_length())
    b_int = rnd.getrandbits(bits - 1)
    T = jl.toeplitz(jl.from_pyints([b_int], Ln)[0], Ln)
    vals = [rnd.getrandbits(bits - 1) % n_int for _ in range(batch)]
    x = jl.from_pyints(vals, Ln)
    out = _check_mul(x, T)
    assert tl.to_pyints(out) == [v * b_int for v in vals]


def _cipher_1024():
    return jax_get_cipher("affine", key_bits=1024, seed=1)


@pytest.mark.parametrize("which", ["encrypt", "barrett_mu", "barrett_n",
                                   "decrypt"])
def test_mul_fixed_plain_equals_jax_kernel_at_1024_bit_shapes(which):
    """The main path's shapes at 1024-bit keys, a few hundred rows:
    encrypt/decrypt x (N, 128) @ (128, 256), Barrett q1 (N, 130) @ T_mu
    (130, 259) and q3 (N, 130) @ T_n (130, 259)."""
    c = _cipher_1024()
    T = np.array({"encrypt": c.T_enc, "decrypt": c.T_dec,
                  "barrett_mu": c.bctx.T_mu,
                  "barrett_n": c.bctx.T_n}[which], np.int32)
    rng = np.random.default_rng(len(which))
    x = rng.integers(0, 256, (300, T.shape[0])).astype(np.int32)
    out = _check_mul(x, T)
    assert out.shape == (300, {"encrypt": 256, "decrypt": 256}.get(which,
                                                                     259))


@pytest.mark.parametrize("Lx,Lb,Lo", [(128, 128, 256), (130, 129, 259),
                                      (64, 64, 128), (32, 32, 20),
                                      (16, 8, 9), (1, 1, 1)])
def test_mul_fixed_all_255_zeros_and_the_wrap(Lx, Lb, Lo):
    """All-255 x and b (the largest column sums, the longest carry
    chains), zeros, and Lo < Lx + Lb (the product wraps mod 2**(8*Lo))."""
    b = np.full(Lb, 255, np.int32)
    T = jl.toeplitz(b, Lx)[:, :Lo].copy()
    x = np.full((5, Lx), 255, np.int32)
    x[1] = 0
    x[2, : Lx // 2] = 0
    out = _check_mul(x, T)
    b_int = (1 << (8 * Lb)) - 1
    assert tl.to_pyints(out) == _product_ints(x, b_int, Lo)
    assert (out[1] == 0).all()


def test_mul_fixed_keeps_leading_axes_and_refuses_bad_input():
    rng = np.random.default_rng(0)
    T = jl.toeplitz(rng.integers(0, 256, 6).astype(np.int32), 5)
    x = rng.integers(0, 256, (2, 3, 5)).astype(np.int32)
    got = mul_fixed(torch.from_numpy(x), torch.from_numpy(T))
    assert got.shape == (2, 3, 11)
    np.testing.assert_array_equal(
        got.reshape(6, 11).numpy(),
        np.asarray(jax_mul_fixed_ref(jnp.asarray(x.reshape(6, 5)),
                                     jnp.asarray(T))))
    xt, Tt = torch.from_numpy(x[0]), torch.from_numpy(T)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mul_fixed(xt.to("meta"), Tt.to("meta"))
    with pytest.raises(ValueError, match="T on"):
        mul_fixed(xt.to("meta"), Tt)
    with pytest.raises(ValueError, match="Lx"):
        mul_fixed(xt, Tt[:4])
    wide = torch.zeros((1, MAX_LX + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="Lx <="):
        mul_fixed(wide, torch.zeros((MAX_LX + 1, 1), dtype=torch.int32))
    # the kernel wrapper takes CUDA tensors only: a CPU tensor never
    # reaches a build or a launch
    with pytest.raises(ValueError, match="CUDA"):
        mul_fixed_cuda(xt, Tt)
    assert mul_fixed.launches == 0


@pytest.mark.parametrize("bits,seed", [(64, 0), (256, 11), (1024, 1)])
def test_modmul_fixed_equals_python_ints_and_jax(bits, seed):
    jc = jax_get_cipher("affine", key_bits=bits, seed=seed)
    tc = get_cipher("affine", key_bits=bits, seed=seed)
    rnd = random.Random(bits)
    vals = [rnd.getrandbits(bits) % tc.n_int for _ in range(200)]
    vals += [0, 1, tc.n_int - 1]
    x = jl.from_pyints(vals, tc.Ln)
    b_int = rnd.getrandbits(bits) % tc.n_int
    T = jl.toeplitz(jl.from_pyints([b_int], tc.Ln)[0], tc.Ln)
    got = modmul_fixed(torch.from_numpy(x), torch.from_numpy(T), tc.bctx)
    assert tl.to_pyints(got) == [(v * b_int) % tc.n_int for v in vals]
    want = jax_modmul_fixed(jnp.asarray(x), jnp.asarray(T), jc.bctx,
                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits,seed", [(192, 9), (256, 11), (512, 3)])
def test_encrypt_and_decrypt_batch_equal_jax(bits, seed):
    """The tests/test_kernels.py kernelized encrypt/decrypt case, port
    against JAX: the same ciphertext limbs, born at ``out_width`` with
    zero limbs on top, and the same plaintexts back."""
    jc = jax_get_cipher("affine", key_bits=bits, seed=seed)
    tc = get_cipher("affine", key_bits=bits, seed=seed)
    rnd = random.Random(3)
    pts = [rnd.getrandbits(bits - 42) for _ in range(40)] + [0, 1]
    pt = jl.from_pyints(pts, tc.Ln)
    ct = encrypt_batch(tc, torch.from_numpy(pt))
    want = np.asarray(jax_encrypt_batch(jc, jnp.asarray(pt), interpret=True))
    np.testing.assert_array_equal(ct.numpy(), want)
    np.testing.assert_array_equal(
        ct.numpy(), np.asarray(jc.encrypt_limbs(jnp.asarray(pt))))
    # narrower plaintexts are padded to Ln; the batch keeps its axes
    narrow = pt[:, : tc.Ln // 2].reshape(6, 7, -1)
    wide = encrypt_batch(tc, torch.from_numpy(narrow),
                         out_width=tc.hist_width)
    assert wide.shape == (6, 7, tc.hist_width)
    np.testing.assert_array_equal(
        wide.reshape(42, -1).numpy(),
        np.asarray(jax_encrypt_batch(jc, jnp.asarray(narrow.reshape(42, -1)),
                                     interpret=True,
                                     out_width=tc.hist_width)))
    assert (wide[..., tc.Ln:] == 0).all()
    back = decrypt_batch(tc, ct)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_decrypt_batch(jc, jnp.asarray(want),
                                                   interpret=True)))
    assert tl.to_pyints(back) == pts
    assert tc.decrypt_to_ints(ct) == pts


def test_encrypt_batch_range_guard():
    tc = get_cipher("affine", key_bits=256, seed=11)
    bad = torch.from_numpy(jl.from_pyints([5, tc.n_int], tc.Ln))
    with pytest.raises(ValueError, match="out of range"):
        encrypt_batch(tc, bad)
    too_wide = torch.zeros((1, tc.Ln + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="wider than modulus"):
        encrypt_batch(tc, too_wide)
    edge = torch.from_numpy(jl.from_pyints([tc.n_int - 1], tc.Ln))
    assert tc.decrypt_to_ints(encrypt_batch(tc, edge)) == [tc.n_int - 1]
