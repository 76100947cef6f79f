"""The port's per-node histogram engine (K5's plain version and
``CipherHistogram.node_histogram``) against the JAX package, on the CPU.

On a CPU tensor ``ciphertext_histogram`` takes the plain version, which
must be ``torch.equal`` to the JAX Pallas kernel (interpret mode, as the
JAX package's own tests run it) on the ``tests/test_kernels.py`` shapes
and seeds, where the JAX reference's fp32 einsum is exact.  The engine's
``node_histogram`` and ``subtract`` must give the JAX engine's canonical
histograms, counts and launch counts for both limb ciphers, and the layer
engine must equal them, as ``tests/test_layer_hist.py`` holds for the JAX
package.  The CUDA kernel itself is held to the same plain version on the
card by ``chip_smoke.py``.  No tolerance: every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.binning import BinnedData as JaxBinnedData
from repro.core.he import get_cipher as jax_get_cipher
from repro.core.histogram import CipherHistogram as JaxEngine
from repro.core.histogram import PlainHistogram as JaxPlainHistogram
from repro.core.party import Stats as JaxStats
from repro.kernels.histogram import ciphertext_histogram as jax_hist
from repro.kernels.histogram import count_histogram as jax_counts
from repro.kernels.histogram import hist_ref as jax_hist_ref

from repro_torch.core.binning import BinnedData, bin_features
from repro_torch.core.frontier import CipherFrontier
from repro_torch.core.he import get_cipher, limbs
from repro_torch.core.histogram import CipherHistogram, PlainHistogram
from repro_torch.core.party import Stats
from repro_torch.kernels.histogram import (ciphertext_histogram,
                                           count_histogram, hist_ref)
from repro_torch.kernels.histogram.histogram import hist_cuda

torch.set_num_threads(1)

# tests/test_kernels.py's HIST_SHAPES: n_i, n_f, L, n_b
HIST_SHAPES = [(64, 3, 8, 8), (300, 17, 33, 32), (257, 9, 130, 16),
               (1024, 8, 20, 32), (1, 1, 4, 4)]


@pytest.mark.parametrize("n_i,n_f,L,n_b", HIST_SHAPES)
def test_ciphertext_histogram_equals_jax_pallas(n_i, n_f, L, n_b):
    rng = np.random.default_rng(n_i * 31 + n_f)
    bins = rng.integers(0, n_b, (n_i, n_f)).astype(np.int32)
    bins[rng.random((n_i, n_f)) < 0.15] = -1
    cts = rng.integers(0, 256, (n_i, L)).astype(np.int32)
    pallas = np.asarray(jax_hist(bins, cts, n_b, use_pallas=True))
    np.testing.assert_array_equal(
        pallas, np.asarray(jax_hist_ref(jnp.asarray(bins), jnp.asarray(cts),
                                        n_b)))
    tb, tc = torch.from_numpy(bins), torch.from_numpy(cts)
    got = ciphertext_histogram(tb, tc, n_b)
    assert got.dtype == torch.int32 and got.shape == (n_f, n_b, L)
    assert torch.equal(got, torch.from_numpy(pallas.copy()))
    assert torch.equal(hist_ref(tb, tc, n_b), got)
    cnt = count_histogram(bins, n_b)
    assert cnt.dtype == np.int32
    np.testing.assert_array_equal(cnt, np.asarray(jax_counts(bins, n_b)))


def test_ciphertext_histogram_masked_all_equals_jax():
    bins = np.full((50, 4), -1, np.int32)
    cts = np.random.default_rng(0).integers(0, 256, (50, 8)).astype(np.int32)
    want = np.asarray(jax_hist(bins, cts, 8))
    got = ciphertext_histogram(torch.from_numpy(bins), torch.from_numpy(cts),
                               8)
    assert (want == 0).all()
    assert torch.equal(got, torch.from_numpy(want.copy()))
    np.testing.assert_array_equal(count_histogram(bins, 8),
                                  np.asarray(jax_counts(bins, 8)))


@pytest.mark.parametrize("seed", range(3))
def test_count_histogram_skips_out_of_range_bins_as_jax(seed):
    """A bin below 0 or at or above n_bins counts nowhere, as the JAX
    one-hot sum counts it."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(-3, 12, (97, 5)).astype(np.int32)
    got = count_histogram(bins, 8)
    np.testing.assert_array_equal(got, np.asarray(jax_counts(bins, 8)))
    assert got.sum() == int(((bins >= 0) & (bins < 8)).sum())


def test_hist_plain_is_exact_past_fp32():
    """80,000 rows of 255 in one cell pass 2**24: the plain version sums
    exactly in int32 (an fp32 one-hot einsum would round there)."""
    n_i = 80000
    bins = np.zeros((n_i, 2), np.int32)
    bins[:, 1] = np.arange(n_i) % 3
    cts = np.full((n_i, 2), 255, np.int32)
    cts[:, 1] = np.arange(n_i) % 256
    got = hist_ref(torch.from_numpy(bins), torch.from_numpy(cts), 4).numpy()
    want = np.zeros((2, 4, 2), np.int64)
    np.add.at(want, (np.arange(2)[None, :], bins), cts[:, None, :])
    assert want.max() > 2 ** 24
    np.testing.assert_array_equal(got, want)


def test_ciphertext_histogram_skips_out_of_range_and_refuses_bad_input():
    bins = torch.tensor([[0, 5], [1, -3], [9, 1]], dtype=torch.int32)
    cts = torch.tensor([[1], [2], [4]], dtype=torch.int32)
    want = torch.zeros((2, 4, 1), dtype=torch.int32)
    want[0, 0, 0], want[0, 1, 0], want[1, 1, 0] = 1, 2, 4
    assert torch.equal(ciphertext_histogram(bins, cts, 4), want)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ciphertext_histogram(bins.to("meta"), cts.to("meta"), 4)
    with pytest.raises(ValueError, match="bins on"):
        ciphertext_histogram(bins.to("meta"), cts, 4)
    # no rows: zeros of the full shape
    empty = ciphertext_histogram(bins[:0], cts[:0], 4)
    assert empty.shape == (2, 4, 1) and not empty.any()
    # the kernel wrapper takes CUDA tensors only: a CPU tensor never
    # reaches a build or a launch
    with pytest.raises(ValueError, match="CUDA"):
        hist_cuda(bins, cts, 4)
    assert ciphertext_histogram.launches == 0


# --------------------------------------------------------------------------
# the per-node engine against the JAX engine
# --------------------------------------------------------------------------

CIPHERS = [("plain", {"bits": 256}), ("affine", {"key_bits": 192, "seed": 7})]


def _node_case(cipher_name, kw, n_slots, n=160, n_f=4, n_b=8, seed=11):
    """Seeded bins and ciphertexts (n, n_slots, Ln) made by the JAX
    cipher, with both packages' cipher, data and engine."""
    rng = np.random.default_rng(seed)
    jc, tc = jax_get_cipher(cipher_name, **kw), get_cipher(cipher_name, **kw)
    bins = rng.integers(0, n_b, (n, n_f)).astype(np.int32)
    pts = [int(v) for v in rng.integers(0, 2 ** 40, n * n_slots)]
    cts = np.array(jc.encrypt_ints(pts)).reshape(n, n_slots, -1)
    jdata = JaxBinnedData(bins=bins, thresholds=None, n_bins=n_b)
    tdata = BinnedData(bins=bins, thresholds=None, n_bins=n_b)
    return (rng, cts, JaxEngine(jc, n_b, use_pallas=True, stats=JaxStats()),
            jdata, CipherHistogram(tc, n_b, stats=Stats()), tdata)


@pytest.mark.parametrize("n_slots", [1, 2])
@pytest.mark.parametrize("cipher_name,kw", CIPHERS)
def test_node_histogram_equals_jax_engine(cipher_name, kw, n_slots):
    rng, cts, jeng, jdata, teng, tdata = _node_case(cipher_name, kw, n_slots)
    n = cts.shape[0]
    tcts = torch.from_numpy(cts)
    for rows in (np.arange(n), np.sort(rng.choice(n, 61, replace=False)),
                 np.zeros(0, np.int64)):
        jh, jc = jeng.node_histogram(jdata, jnp.asarray(cts), rows)
        th, tc = teng.node_histogram(tdata, tcts, rows)
        assert th.dtype == torch.int32
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert tc.dtype == np.int64 and jc.dtype == np.int64
        np.testing.assert_array_equal(tc, jc)
    # one launch per call, empty rows too, as the JAX engine counts
    assert teng.stats.n_hist_launches == jeng.stats.n_hist_launches == 3
    # subtraction: the parent minus a child is the sibling, canonical
    parent = teng.node_histogram(tdata, tcts, np.arange(n))
    child = teng.node_histogram(tdata, tcts, np.arange(0, n, 3))
    sib = teng.subtract(parent, child)
    jsib = jeng.subtract((parent[0].numpy(), parent[1]),
                         (child[0].numpy(), child[1]))
    np.testing.assert_array_equal(sib[0].numpy(), np.asarray(jsib[0]))
    np.testing.assert_array_equal(sib[1], jsib[1])
    other = np.setdiff1d(np.arange(n), np.arange(0, n, 3))
    direct = teng.node_histogram(tdata, tcts, other)
    assert torch.equal(sib[0], direct[0])
    np.testing.assert_array_equal(sib[1], direct[1])


def test_node_histogram_refuses_numpy_cts_and_object_ciphers():
    _, cts, _, _, teng, tdata = _node_case("plain", {"bits": 256}, 1, n=20)
    with pytest.raises(TypeError, match="tensor"):
        teng.node_histogram(tdata, cts, np.arange(20))

    class ObjectCipher:
        backend, name = "object", "paillier"

    with pytest.raises(NotImplementedError, match="M2"):
        CipherHistogram(ObjectCipher(), 8).node_histogram(
            tdata, torch.from_numpy(cts), np.arange(20))
    assert teng.stats.n_hist_launches == 0


@pytest.mark.parametrize("cipher_name,kw", CIPHERS)
def test_layer_histograms_match_per_node_engine(cipher_name, kw):
    """The port's mirror of ``tests/test_layer_hist.py``'s test of the
    same name: batched direct + lazy-subtract accumulation (K1) against
    node_histogram / subtract (K5), through the frontier state, and the
    decrypted cells against the plaintext sums."""
    rng = np.random.default_rng(11)
    n, n_f, n_b = 160, 4, 8
    cipher = get_cipher(cipher_name, **kw)
    X = rng.normal(0, 1, (n, n_f)).astype(np.float32)
    data = bin_features(X, n_b, device="cpu")
    pts = rng.integers(0, 2**40, n)
    cts = cipher.encrypt_ints([int(v) for v in pts], device="cpu")
    cts = cts.reshape(n, 1, -1)

    engine = CipherHistogram(cipher, n_b, stats=Stats())
    frontier = CipherFrontier(engine, data, cts)
    # one parent node split into two children; right child by subtraction
    parent_rows = np.arange(n)
    left_rows = np.arange(n // 3)
    right_rows = np.arange(n // 3, n)
    cache = {0: engine.node_histogram(data, cts, parent_rows)}
    frontier.store(0, *cache[0])

    batched = frontier.layer_histograms(
        {1: left_rows, 2: right_rows}, direct=[1], subtract=[(2, 0, 1)])
    h1, c1 = engine.node_histogram(data, cts, left_rows)
    h2, c2 = engine.subtract(cache[0], (h1, c1))
    assert torch.equal(batched[1][0], h1)
    np.testing.assert_array_equal(batched[1][1], c1)
    assert torch.equal(batched[2][0], h2)
    np.testing.assert_array_equal(batched[2][1], c2)
    assert engine.stats.n_hist_launches == 3
    # decrypted bin sums must equal plaintext bin sums
    dec = limbs.to_pyints(cipher.decrypt_limbs(batched[2][0]))
    dec = np.asarray(dec, dtype=object).reshape(n_f, n_b)
    for f in range(n_f):
        for b in range(n_b):
            expect = int(sum(int(v) for v, bb in
                             zip(pts[right_rows], data.bins[right_rows, f])
                             if bb == b))
            assert int(dec[f, b]) == expect, (f, b)


@pytest.mark.parametrize("out_dim", [(), (3,)])
def test_plain_node_histogram_equals_jax(out_dim):
    """``tests/test_frontier.py``'s guest shape (200 rows, 4 features, 8
    bins): the port's PlainHistogram.node_histogram is the JAX one's dense
    branch, bit for bit, and its layer path gives the same (G, H, C)."""
    rng = np.random.default_rng(1)
    n, n_f, n_b = 200, 4, 8
    bins = rng.integers(0, n_b, (n, n_f)).astype(np.int32)
    g = rng.normal(0, 1, (n,) + out_dim)
    h = rng.random((n,) + out_dim)
    rows = np.sort(rng.choice(n, 150, replace=False))
    got = PlainHistogram(n_b).node_histogram(
        BinnedData(bins=bins, thresholds=None, n_bins=n_b), g, h, rows)
    want = JaxPlainHistogram(n_b).node_histogram(
        JaxBinnedData(bins=bins, thresholds=None, n_bins=n_b), g, h, rows)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    layer = PlainHistogram(n_b).layer_histograms(
        BinnedData(bins=bins, thresholds=None, n_bins=n_b), g, h,
        {0: rows}, [0], [], {})[0]
    for a, b in zip(layer, got):
        np.testing.assert_array_equal(a, b)


def test_plain_cipher_encrypt_ints_and_decrypt_limbs_equal_jax():
    tc, jc = get_cipher("plain", bits=256), jax_get_cipher("plain", bits=256)
    xs = [0, 1, 2 ** 40 - 1, 2 ** 255 - 1, 12345678901234567890]
    got = tc.encrypt_ints(xs, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc.encrypt_ints(xs)))
    assert tc.decrypt_limbs(got) is got
    assert tc.decrypt_to_ints(tc.decrypt_limbs(got)) == xs
    for cipher in (tc, get_cipher("affine", key_bits=64, seed=3)):
        zero = cipher.zero((2, 3), device="cpu")
        assert zero.shape == (2, 3, cipher.Ln) and not zero.any()
