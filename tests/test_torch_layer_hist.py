"""The port's layer histogram (K1's plain version) and the limb path of its
histogram engine against the JAX package, on the CPU.

On a CPU tensor ``layer_ciphertext_histogram`` takes the plain version,
which must be ``torch.equal`` to the JAX Pallas kernel (interpret mode)
and to the JAX reference at sizes where the reference's fp32 einsum is
exact: masked rows and slots, 1, 3 and 4 nodes, W of 1 and 131, row
counts off the kernel's tiles.  The engine's layer batch (one direct
launch, lazy subtraction from cached parents, one reduce, the cumsum) must
give the JAX engine's lazy sums, canonical histograms, counts and cumsums.
The CUDA kernel itself is held to the same plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.binning import BinnedData as JaxBinnedData
from repro.core.frontier import CipherFrontier as JaxFrontier
from repro.core.he.plain import PlainCipher as JaxPlain
from repro.core.histogram import CipherHistogram as JaxEngine
from repro.kernels.histogram import layer_count_histogram as jax_counts
from repro.kernels.histogram import layer_hist_ref as jax_layer_hist_ref
from repro.kernels.histogram.histogram import layer_hist_pallas

from repro_torch.core.binning import BinnedData
from repro_torch.core.frontier import CipherFrontier
from repro_torch.core.he.plain import PlainCipher
from repro_torch.core.histogram import CipherHistogram
from repro_torch.core.party import Stats
from repro_torch.kernels.histogram import (layer_ciphertext_histogram,
                                           layer_count_histogram,
                                           layer_hist_ref)
from repro_torch.kernels.histogram.histogram import layer_hist_cuda

torch.set_num_threads(1)


def _inputs(n_i, n_f, n_b, n_nodes, W, seed, p_mask=0.15):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_b, (n_i, n_f)).astype(np.int32)
    bins[rng.random((n_i, n_f)) < p_mask] = -1
    slot = rng.integers(0, n_nodes, n_i).astype(np.int32)
    slot[rng.random(n_i) < p_mask] = -1
    cts = rng.integers(0, 256, (n_i, W)).astype(np.int32)
    return bins, slot, cts


CASES = [  # n_i, n_f, n_b, n_nodes, W
    (300, 5, 8, 1, 131),
    (300, 5, 8, 3, 131),
    (257, 3, 16, 4, 131),
    (513, 9, 8, 4, 1),
    (77, 2, 4, 3, 1),
    (1, 1, 2, 1, 3),
]


@pytest.mark.parametrize("n_i,n_f,n_b,n_nodes,W", CASES)
def test_layer_hist_plain_equals_jax(n_i, n_f, n_b, n_nodes, W):
    bins, slot, cts = _inputs(n_i, n_f, n_b, n_nodes, W, seed=n_i + W)
    pallas = np.asarray(layer_hist_pallas(
        jnp.asarray(bins), jnp.asarray(slot), jnp.asarray(cts), n_nodes,
        n_b, interpret=True))
    ref = np.asarray(jax_layer_hist_ref(
        jnp.asarray(bins), jnp.asarray(slot), jnp.asarray(cts), n_nodes, n_b))
    np.testing.assert_array_equal(pallas, ref)
    args = (torch.from_numpy(bins), torch.from_numpy(slot),
            torch.from_numpy(cts))
    got = layer_ciphertext_histogram(*args, n_nodes, n_b)
    assert got.dtype == torch.int32 and got.shape == (n_nodes, n_f, n_b, W)
    assert torch.equal(got, torch.from_numpy(pallas.copy()))
    assert torch.equal(layer_hist_ref(*args, n_nodes, n_b), got)
    np.testing.assert_array_equal(
        layer_count_histogram(bins, slot, n_nodes, n_b),
        np.asarray(jax_counts(bins, slot, n_nodes, n_b)))


def test_layer_hist_plain_is_exact_past_fp32():
    """65,794+ rows of 255 in one cell pass 2**24: the plain version sums
    exactly in int32 (an fp32 one-hot einsum would round there)."""
    n_i = 80000
    bins = np.zeros((n_i, 2), np.int32)
    bins[:, 1] = np.arange(n_i) % 3
    slot = np.zeros(n_i, np.int32)
    slot[::11] = 1
    cts = np.full((n_i, 2), 255, np.int32)
    cts[:, 1] = np.arange(n_i) % 256
    got = layer_hist_ref(torch.from_numpy(bins), torch.from_numpy(slot),
                         torch.from_numpy(cts), 2, 4).numpy()
    want = np.zeros((2, 2, 4, 2), np.int64)
    np.add.at(want, (slot[:, None], np.arange(2)[None, :], bins),
              cts[:, None, :])
    assert want.max() > 2 ** 24
    np.testing.assert_array_equal(got, want)


def test_layer_hist_skips_out_of_range_and_refuses_bad_input():
    bins = torch.tensor([[0, 5], [1, -3], [9, 1]], dtype=torch.int32)
    slot = torch.tensor([0, 2, 1], dtype=torch.int32)
    cts = torch.tensor([[1], [2], [4]], dtype=torch.int32)
    out = layer_ciphertext_histogram(bins, slot, cts, 2, 4)
    # row 1's slot and row 2's first bin are out of range; bin 5 too
    want = torch.zeros((2, 2, 4, 1), dtype=torch.int32)
    want[0, 0, 0, 0] = 1
    want[1, 1, 1, 0] = 4
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="cuda or cpu"):
        layer_ciphertext_histogram(bins.to("meta"), slot.to("meta"),
                                   cts.to("meta"), 2, 4)
    with pytest.raises(ValueError, match="bins on"):
        layer_ciphertext_histogram(bins.to("meta"), slot, cts, 2, 4)
    # the kernel wrapper takes CUDA tensors only: a CPU tensor never
    # reaches a build or a launch
    with pytest.raises(ValueError, match="CUDA"):
        layer_hist_cuda(bins, slot, cts, 2, 4)
    assert layer_ciphertext_histogram.launches == 0


# --------------------------------------------------------------------------
# the engine's layer batch against the JAX engine
# --------------------------------------------------------------------------

N_ROWS, N_F, N_B = 240, 4, 8


def _frontiers(n_slots=1, seed=5):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, N_B, (N_ROWS, N_F)).astype(np.int32)
    jc, tc = JaxPlain(bits=256), PlainCipher(bits=256)
    width = tc.hist_width
    cts = np.zeros((N_ROWS, n_slots, width), np.int32)
    cts[..., : tc.Ln] = rng.integers(0, 256, (N_ROWS, n_slots, tc.Ln))
    jeng = JaxEngine(jc, N_B, use_pallas=True)
    teng = CipherHistogram(tc, N_B, stats=Stats())
    jf = JaxFrontier(jeng, JaxBinnedData(bins=bins, thresholds=None,
                                         n_bins=N_B), jnp.asarray(cts))
    tf = CipherFrontier(teng, BinnedData(bins=bins, thresholds=None,
                                         n_bins=N_B), torch.from_numpy(cts))
    assert tf.n_cts_placements == 0
    return rng, jf, tf


# three layers: the root directly, then one direct child and its sibling
# by subtraction, then two direct grandchildren and two by subtraction
def _layers(rng):
    rows = {0: np.arange(N_ROWS)}
    split1 = rng.random(N_ROWS) < 0.4
    rows[1], rows[2] = np.where(split1)[0], np.where(~split1)[0]
    for par, (a, b) in ((1, (3, 4)), (2, (5, 6))):
        go = rng.random(len(rows[par])) < 0.5
        rows[a], rows[b] = rows[par][go], rows[par][~go]
    return [({0: rows[0]}, [0], []),
            ({1: rows[1], 2: rows[2]}, [1], [(2, 0, 1)]),
            ({k: rows[k] for k in (3, 4, 5, 6)}, [3, 5],
             [(4, 1, 3), (6, 2, 5)])]


@pytest.mark.parametrize("n_slots", [1, 2])
def test_engine_layer_batch_equals_jax(n_slots):
    rng, jf, tf = _frontiers(n_slots)
    for node_rows, direct, subtract in _layers(rng):
        slot = tf.layer_slots(node_rows, direct)
        np.testing.assert_array_equal(slot, jf.layer_slots(node_rows, direct))
        lazy_t = tf.engine._layer_dispatch(tf, slot, len(direct))
        lazy_j = jf.engine._layer_dispatch(jf, slot, len(direct))
        np.testing.assert_array_equal(lazy_t.numpy(), np.asarray(lazy_j))
        got = tf.layer_histograms(node_rows, direct, subtract)
        want = jf.layer_histograms(node_rows, direct, subtract)
        assert sorted(got) == sorted(want)
        for nid in want:
            np.testing.assert_array_equal(got[nid][0].numpy(),
                                          np.asarray(want[nid][0]))
            assert ((got[nid][0] >= 0) & (got[nid][0] <= 255)).all()
            np.testing.assert_array_equal(got[nid][1], want[nid][1])
        nids = sorted(want)
        cum_t = tf.engine.cumsum(torch.stack([got[n][0] for n in nids]))
        cum_j = jf.engine.cumsum(jnp.stack([want[n][0] for n in nids]))
        assert cum_t.dtype == torch.int32
        np.testing.assert_array_equal(cum_t.numpy(), np.asarray(cum_j))
    # one launch per layer (and one per direct _layer_dispatch call above),
    # counted on the engine's Stats
    assert tf.engine.stats.n_hist_launches == 2 * 3
    assert tf.evict_except({1}) == jf.evict_except({1}) == 1


def test_engine_cumsum_stays_int32_on_lazy_sums():
    """A cumsum over 32 bins of limbs near 2**24 passes 2**24 but not
    2**31: summed in int32 it is what the JAX engine computes."""
    rng = np.random.default_rng(9)
    hist = rng.integers(0, 1 << 24, (2, 3, 32, 1, 7)).astype(np.int32)
    tc, jc = PlainCipher(bits=32), JaxPlain(bits=32)
    got = CipherHistogram(tc, 32).cumsum(torch.from_numpy(hist))
    want = JaxEngine(jc, 32).cumsum(jnp.asarray(hist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
