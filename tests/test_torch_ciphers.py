"""The port's cipher suites against the JAX package's, on the CPU: the
cases of ``tests/test_ciphers.py`` for the limb suites, plus equality
with the JAX package limb for limb.

* affine ``keygen`` draws the JAX package's ``(n, a)`` for every seed and
  key size, and its ciphertexts are the JAX package's limbs;
* round trip, ``add`` / ``sub`` / ``mul_pow2`` homomorphism (python ints
  and the JAX package's limbs);
* the lazy histogram hooks: a lazy sum reduced, ``lazy_sub`` then
  ``reduce``;
* the ``>= n`` range guard, and n - 1 round-trips;
* Paillier is not ported (ROADMAP M2) and a cipher made without
  ``device="cpu"`` refuses to run quietly on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.he import get_cipher as jax_get_cipher
from repro.core.he import limbs as jl
from repro.kernels.modmul import encrypt_batch as jax_encrypt_batch

from repro_torch.core.he import get_cipher
from repro_torch.core.he import limbs as tl

torch.set_num_threads(1)

CPU = "cpu"


def _suites(name):
    if name == "plain":
        return get_cipher("plain", bits=256), jax_get_cipher("plain",
                                                             bits=256)
    return (get_cipher("affine", key_bits=256, seed=11),
            jax_get_cipher("affine", key_bits=256, seed=11))


@pytest.mark.parametrize("key_bits", [64, 192, 256, 512, 1024])
@pytest.mark.parametrize("seed", [0, 1, 11])
def test_affine_keygen_equals_jax(key_bits, seed):
    tc = get_cipher("affine", key_bits=key_bits, seed=seed)
    jc = jax_get_cipher("affine", key_bits=key_bits, seed=seed)
    assert (tc.n_int, tc.a_int, tc.a_inv_int) == \
        (jc.n_int, jc.a_int, jc.a_inv_int)
    assert (tc.Ln, tc.plaintext_bits, tc.hist_width) == \
        (jc.Ln, jc.plaintext_bits, jc.hist_width)
    np.testing.assert_array_equal(tc.T_enc.host, np.asarray(jc.T_enc))
    np.testing.assert_array_equal(tc.T_dec.host, np.asarray(jc.T_dec))


@pytest.mark.parametrize("key_bits,seed", [(256, 11), (1024, 1)])
def test_affine_ciphertexts_equal_jax(key_bits, seed):
    tc = get_cipher("affine", key_bits=key_bits, seed=seed)
    jc = jax_get_cipher("affine", key_bits=key_bits, seed=seed)
    rng = np.random.default_rng(seed)
    pt = rng.integers(0, 256, (64, tc.Ln - 1)).astype(np.int32)
    ct = tc.encrypt_limbs(torch.from_numpy(pt))
    np.testing.assert_array_equal(
        ct.numpy(), np.asarray(jax_encrypt_batch(jc, jnp.asarray(pt),
                                                 interpret=True)))
    np.testing.assert_array_equal(
        ct.numpy(), np.asarray(jc.encrypt_limbs(jnp.asarray(pt))))
    xs = [0, 1, 12345, 2 ** 100 + 7]
    np.testing.assert_array_equal(tc.encrypt_ints(xs, device=CPU).numpy(),
                                  np.asarray(jc.encrypt_ints(xs)))
    assert tc.decrypt_to_ints(ct) == jc.decrypt_to_ints(np.asarray(ct))


@pytest.mark.parametrize("name", ["plain", "affine"])
def test_roundtrip_and_homomorphism(name):
    tc, jc = _suites(name)
    xs = [0, 1, 12345, 2 ** 100 + 7]
    ys = [5, 9, 2 ** 90, 3]
    mod = 2 ** tc.plaintext_bits if name == "plain" else tc.n_int
    if name == "plain":
        ca = tc.encrypt_limbs(torch.from_numpy(tl.from_pyints(xs, tc.Ln)))
        cb = tc.encrypt_limbs(torch.from_numpy(tl.from_pyints(ys, tc.Ln)))
    else:
        ca, cb = tc.encrypt_ints(xs, device=CPU), tc.encrypt_ints(
            ys, device=CPU)
    assert tc.decrypt_to_ints(ca) == xs
    ja, jb = jnp.asarray(ca.numpy()), jnp.asarray(cb.numpy())
    s = tc.add(ca, cb)
    np.testing.assert_array_equal(s.numpy(), np.asarray(jc.add(ja, jb)))
    assert tc.decrypt_to_ints(s) == [(x + y) % mod for x, y in zip(xs, ys)]
    d = tc.sub(s, cb)
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jc.sub(jc.add(ja, jb), jb)))
    assert tc.decrypt_to_ints(d) == xs
    m = tc.mul_pow2(ca, 13)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jc.mul_pow2(ja, 13)))
    assert tc.decrypt_to_ints(m) == [(x << 13) % mod for x in xs]


def test_affine_lazy_reduce():
    tc, jc = _suites("affine")
    xs = [3, 5, 2 ** 128, 2 ** 200 + 1, 17]
    ct = tc.encrypt_ints(xs, device=CPU)
    acc = tl.pad_limbs(ct, tc.hist_width).sum(dim=0, dtype=torch.int32)
    red = tc.reduce(acc[None])
    assert red.shape == (1, tc.Ln)
    assert tc.decrypt_to_ints(red) == [sum(xs) % tc.n_int]
    np.testing.assert_array_equal(
        red.numpy(), np.asarray(jc.reduce(jnp.asarray(acc.numpy())[None])))


def test_affine_lazy_sub_then_reduce_equals_jax():
    """A canonical parent histogram minus a lazy child sum, with the
    ``count_bound * n`` offset, reduced: the JAX package's limbs and the
    sibling's sum mod n."""
    tc, jc = _suites("affine")
    rng = np.random.default_rng(2)
    vals = [int(v) for v in rng.integers(0, 2 ** 62, 40)]
    take = rng.random(40) < 0.4
    cts = tl.pad_limbs(tc.encrypt_ints(vals, device=CPU), tc.hist_width)
    parent = tc.reduce(cts.sum(dim=0, dtype=torch.int32)[None])[0]
    child = cts[torch.from_numpy(take)].sum(dim=0, dtype=torch.int32)
    lazy = tc.lazy_sub(parent, child, int(take.sum()))
    want_lazy = jc.lazy_sub(jnp.asarray(parent.numpy()),
                            jnp.asarray(child.numpy()), int(take.sum()))
    np.testing.assert_array_equal(lazy.numpy(), np.asarray(want_lazy))
    assert (lazy < 0).any()
    sib = tc.reduce(lazy[None])
    np.testing.assert_array_equal(sib.numpy(),
                                  np.asarray(jc.reduce(want_lazy[None])))
    assert tc.decrypt_to_ints(sib) == \
        [sum(v for v, t in zip(vals, take) if not t) % tc.n_int]
    zero = tc.zero((2, 3), device=CPU)
    assert zero.dtype == torch.int32
    np.testing.assert_array_equal(zero.numpy(), np.asarray(jc.zero((2, 3))))


def test_affine_encrypt_rejects_out_of_range():
    """Values >= n raise, as in the JAX package, rather than wrap silently
    and decrypt to garbage; n - 1 still round-trips."""
    tc, _ = _suites("affine")
    bad = torch.from_numpy(tl.from_pyints([tc.n_int], tc.Ln))
    with pytest.raises(ValueError, match="out of range"):
        tc.encrypt_limbs(bad)
    with pytest.raises(ValueError, match="out of range"):
        tc.encrypt_ints([tc.n_int + 5], device=CPU)
    with pytest.raises(ValueError, match="wider than modulus"):
        tc.encrypt_limbs(torch.zeros((1, tc.Ln + 1), dtype=torch.int32))
    edge = tc.encrypt_ints([tc.n_int - 1], device=CPU)
    assert tc.decrypt_to_ints(edge) == [tc.n_int - 1]


def test_paillier_is_not_ported_and_no_quiet_cpu(monkeypatch):
    with pytest.raises(NotImplementedError, match="M2"):
        get_cipher("paillier", key_bits=256, seed=11)
    with pytest.raises(ValueError, match="unknown"):
        get_cipher("rot13")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc, _ = _suites("affine")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.encrypt_ints([1])
