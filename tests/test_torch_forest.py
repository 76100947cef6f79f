"""The port's round-forests (``forest_size=k``) against the JAX package, on
the CPU.

K4's plain version (``forest_ciphertext_histogram`` on CPU tensors) must be
``torch.equal`` to the JAX Pallas kernel in interpret mode and to the JAX
reference: the shape of ``tests/test_pipeline.py``'s kernel test, a member
with no rows, all rows masked, k = 1 (which is K1), and 67 and 131 limbs.
The engine's forest layer (one launch over (member, node), the gather back
into direct order, lazy subtraction, one reduce) must give the JAX
engine's histograms and counts.  Forest fits with the plain and the affine
cipher (``key_bits=256``, ``precision=20``) on the shape of
``test_forest_grows_k_trees_per_round_and_cipher_parity`` must equal the
JAX fits: member trees (``FederatedTree.signature()`` and host tables),
training and served scores, ``channel.summary()`` and the integer
``Stats``; a forest round replays bit-identically.  The CUDA kernel itself
is held to the same plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import SBTParams as JaxParams
from repro.core import VerticalBoosting as JaxBoosting
from repro.core.binning import BinnedData as JaxBinnedData
from repro.core.frontier import CipherFrontier as JaxFrontier
from repro.core.he.plain import PlainCipher as JaxPlain
from repro.core.histogram import GID_STRIDE as JAX_GID_STRIDE
from repro.core.histogram import CipherHistogram as JaxEngine
from repro.kernels.histogram import \
    forest_ciphertext_histogram as jax_forest_hist
from repro.kernels.histogram import forest_hist_ref as jax_forest_hist_ref
from repro.serving.packed import pack_guest as jax_pack_guest

from repro_torch.core import SBTParams, VerticalBoosting
from repro_torch.core.binning import BinnedData
from repro_torch.core.frontier import CipherFrontier
from repro_torch.core.he.plain import PlainCipher
from repro_torch.core.histogram import GID_STRIDE, CipherHistogram
from repro_torch.core.party import Stats
from repro_torch.kernels.histogram import (forest_ciphertext_histogram,
                                           forest_hist_ref,
                                           layer_ciphertext_histogram)
from repro_torch.kernels.histogram.histogram import forest_hist_cuda
from repro_torch.serving import (FederatedPredictor, PackedEnsemble,
                                 pack_guest)

torch.set_num_threads(1)

CPU = "cpu"


# --------------------------------------------------------------------------
# K4's plain version against the JAX kernel
# --------------------------------------------------------------------------

def _k4_inputs(n_i, n_f, n_b, k, n_nodes, L, seed):
    """``tests/test_pipeline.py``'s generator: bins and slots drawn from
    [-1, n), so about one in (n + 1) is masked."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(-1, n_b, (n_i, n_f)).astype(np.int32)
    slot = rng.integers(-1, n_nodes, (n_i, k)).astype(np.int32)
    cts = rng.integers(0, 256, (n_i, L)).astype(np.int32)
    return bins, slot, cts


def _no_rows_in_member_1(bins, slot, cts):
    slot[:, 1] = -1
    return bins, slot, cts


def _all_slots_masked(bins, slot, cts):
    return bins, np.full_like(slot, -1), cts


def _all_bins_masked(bins, slot, cts):
    return np.full_like(bins, -1), slot, cts


K4_CASES = {  # n_i, n_f, n_b, k, n_nodes, L, seed, edit
    "test_pipeline_shape": (257, 5, 8, 3, 4, 6, 0, None),
    "member_without_rows": (257, 5, 8, 3, 4, 6, 1, _no_rows_in_member_1),
    "all_slots_masked": (130, 4, 8, 3, 2, 6, 2, _all_slots_masked),
    "all_bins_masked": (130, 4, 8, 2, 2, 6, 3, _all_bins_masked),
    "W67_k4": (300, 4, 16, 4, 3, 67, 4, None),
    "W131_k2": (200, 3, 8, 2, 2, 131, 5, None),
    "k1_is_the_layer_histogram": (300, 5, 8, 1, 3, 131, 6, None),
}


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_forest_hist_plain_equals_jax(case):
    n_i, n_f, n_b, k, n_nodes, L, seed, edit = K4_CASES[case]
    bins, slot, cts = _k4_inputs(n_i, n_f, n_b, k, n_nodes, L, seed)
    if edit is not None:
        bins, slot, cts = edit(bins, slot, cts)
    pallas = np.asarray(jax_forest_hist(bins, slot, cts, n_nodes, n_b,
                                        use_pallas=True))
    ref = np.asarray(jax_forest_hist_ref(
        jnp.asarray(bins), jnp.asarray(slot), jnp.asarray(cts), n_nodes, n_b))
    np.testing.assert_array_equal(pallas, ref)
    args = (torch.from_numpy(bins), torch.from_numpy(slot),
            torch.from_numpy(cts))
    got = forest_ciphertext_histogram(*args, n_nodes, n_b)
    assert got.dtype == torch.int32
    assert got.shape == (k, n_nodes, n_f, n_b, L)
    assert torch.equal(got, torch.from_numpy(pallas.copy()))
    assert torch.equal(forest_hist_ref(*args, n_nodes, n_b), got)
    if edit in (_all_slots_masked, _all_bins_masked):
        assert not got.any()
    if edit is _no_rows_in_member_1:
        assert not got[1].any() and got[0].any() and got[2].any()
    if k == 1:
        assert torch.equal(got[0], layer_ciphertext_histogram(
            args[0], args[1][:, 0], args[2], n_nodes, n_b))


def test_forest_hist_refuses_other_devices():
    bins, slot, cts = (torch.from_numpy(a)
                       for a in _k4_inputs(20, 2, 4, 2, 2, 3, 7))
    with pytest.raises(ValueError, match="cuda or cpu"):
        forest_ciphertext_histogram(bins.to("meta"), slot.to("meta"),
                                    cts.to("meta"), 2, 4)
    with pytest.raises(ValueError, match="node_slot on"):
        forest_ciphertext_histogram(bins, slot.to("meta"), cts, 2, 4)
    # the kernel wrapper takes CUDA tensors only: a CPU tensor never
    # reaches a build or a launch
    with pytest.raises(ValueError, match="CUDA"):
        forest_hist_cuda(bins, slot, cts, 2, 4)
    assert forest_ciphertext_histogram.launches == 0


# --------------------------------------------------------------------------
# the engine's forest layer against the JAX engine
# --------------------------------------------------------------------------

def test_forest_layer_histograms_equal_jax_engine():
    """One forest layer of three members: direct gids in member-interleaved
    order, one subtract per member from a cached parent; the port's
    histograms and counts equal the JAX engine's, and the launch is one."""
    assert GID_STRIDE == JAX_GID_STRIDE
    n, n_f, n_b, k = 240, 4, 8, 3
    rng = np.random.default_rng(9)
    bins = rng.integers(0, n_b, (n, n_f)).astype(np.int32)
    jc, tc = JaxPlain(bits=256), PlainCipher(bits=256)
    cts = np.zeros((n, 1, tc.hist_width), np.int32)
    cts[..., : tc.Ln] = rng.integers(0, 256, (n, 1, tc.Ln))
    jeng = JaxEngine(jc, n_b, use_pallas=True)
    teng = CipherHistogram(tc, n_b, stats=Stats())
    jf = JaxFrontier(jeng, JaxBinnedData(bins=bins, thresholds=None,
                                         n_bins=n_b), jnp.asarray(cts))
    tf = CipherFrontier(teng, BinnedData(bins=bins, thresholds=None,
                                         n_bins=n_b), torch.from_numpy(cts))
    # layer 0: each member's root over its bag
    bags = [np.sort(rng.choice(n, 190, replace=False)) for _ in range(k)]
    roots = [m * GID_STRIDE for m in range(k)]
    rows0 = dict(zip(roots, bags))
    for fr in (jf, tf):
        fr.layer_histograms(rows0, roots, [], forest=k)
    # layer 1: member m's root splits; left direct, right subtracted
    rows1, direct, subtract = {}, [], []
    for m, root in enumerate(roots):
        bag = rows0[root]
        left = bag[bins[bag, m % n_f] < 3 + m]
        right = np.setdiff1d(bag, left)
        gl, gr = root + 1, root + 2
        rows1[gl], rows1[gr] = left, right
        direct.append(gl)
        subtract.append((gr, root, gl))
    direct = direct[::-1]                # not member-major
    jout = jf.layer_histograms(rows1, direct, subtract, forest=k)
    tout = tf.layer_histograms(rows1, direct, subtract, forest=k)
    assert sorted(tout) == sorted(jout) == sorted(rows1)
    for gid in rows1:
        np.testing.assert_array_equal(tout[gid][0].numpy(),
                                      np.asarray(jout[gid][0]))
        np.testing.assert_array_equal(tout[gid][1], np.asarray(jout[gid][1]))
    assert teng.stats.n_hist_launches == 2
    assert teng.stats.peak_block_bytes == \
        (bins.size + n * k + n * tc.hist_width) * 4


# --------------------------------------------------------------------------
# forest fits against the JAX package
# --------------------------------------------------------------------------

def _data(n=250, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    w = rng.normal(0, 1, d)
    y = (X @ w + 0.3 * rng.normal(0, 1, n) > 0).astype(np.float64)
    return X, y


def _int_stats(stats):
    return {k: v for k, v in stats.as_dict().items()
            if isinstance(v, int) and not isinstance(v, bool)}


# tests/test_pipeline.py::test_forest_grows_k_trees_per_round_and_cipher_
# parity: 2 rounds of 3 members, 3 guest and 5 host columns
FOREST = dict(n_trees=2, max_depth=3, n_bins=16, forest_size=3, seed=11)
CIPHERS = {"plain": dict(cipher="plain"),
           "affine": dict(cipher="affine", key_bits=256, precision=20)}


@pytest.fixture(scope="module", params=sorted(CIPHERS))
def forest_fit(request):
    kw = dict(FOREST, **CIPHERS[request.param])
    X, y = _data()
    Xg, Xh = X[:, :3], [X[:, 3:]]
    jm = JaxBoosting(JaxParams(**kw)).fit(Xg, y, Xh)
    tm = VerticalBoosting(SBTParams(device=CPU, **kw)).fit(Xg, y, Xh)
    return dict(name=request.param, kw=kw, Xg=Xg, Xh=Xh, y=y, jm=jm, tm=tm)


def test_forest_fit_equals_jax_fit(forest_fit):
    tm, jm = forest_fit["tm"], forest_fit["jm"]
    assert tm.trees_per_round == jm.trees_per_round == 3
    assert len(tm.trees) == len(jm.trees) == 2 * 3
    for a, b in zip(tm.trees, jm.trees):
        assert a.signature() == b.signature()
        assert a.host_tables == b.host_tables
    # one enc_gh round-trip per ROUND, not per member tree
    assert tm.channel.msgs["enc_gh"] == 2
    # one forest launch and one split round-trip per (round, layer)
    assert tm.stats.n_hist_launches == jm.stats.n_hist_launches == 2 * 3
    assert tm.channel.summary() == jm.channel.summary()
    assert _int_stats(tm.stats) == _int_stats(jm.stats)
    assert len(tm.stats.tree_seconds) == 2
    np.testing.assert_array_equal(tm.train_score_, jm.train_score_)


def test_forest_model_serves_like_jax(forest_fit):
    """The forest model through the port's packed ``FederatedPredictor``
    (each member keeps local node ids and its own host tables) equals JAX
    ``predict_score`` and the port's per-node oracle."""
    tm, jm = forest_fit["tm"], forest_fit["jm"]
    Xg, Xh = forest_fit["Xg"], forest_fit["Xh"]
    ens = PackedEnsemble.from_model(tm, device=CPU)
    assert ens.guest.n_trees == 6
    served = FederatedPredictor(ens.guest, ens.hosts,
                                device=CPU).predict_score(Xg, Xh)
    want = jm.predict_score(Xg, Xh)
    np.testing.assert_array_equal(served, want)
    np.testing.assert_array_equal(tm.predict_score(Xg, Xh, packed=False),
                                  want)
    np.testing.assert_array_equal(tm.predict_score(Xg, Xh), want)
    assert tm.channel.summary() == jm.channel.summary()
    _, keys = pack_guest(tm, device=CPU)
    assert keys == jax_pack_guest(jm)[1]


def test_forest_requires_binary():
    X, _ = _data(n=100)
    s = X @ np.ones(X.shape[1])
    y = ((s > np.quantile(s, 0.33)).astype(float)
         + (s > np.quantile(s, 0.66)).astype(float))
    kw = dict(n_trees=1, max_depth=2, n_bins=8, forest_size=2,
              objective="multiclass", n_classes=3)
    with pytest.raises(ValueError, match="forest_size"):
        JaxBoosting(JaxParams(**kw)).fit(X[:, :3], y, [X[:, 3:]])
    with pytest.raises(ValueError, match="forest_size"):
        VerticalBoosting(SBTParams(device=CPU, **kw)).fit(X[:, :3], y,
                                                          [X[:, 3:]])


def test_forest_round_replay_is_bit_identical():
    """A forest round is the resume boundary: ``boost_round`` checks and
    ``rollback_to_round`` truncates k trees a round, and a replayed round
    regrows the same k members (bags and shuffles keyed by the absolute
    tree index)."""
    X, y = _data(n=200, seed=3)
    p = SBTParams(n_trees=3, max_depth=2, n_bins=8, forest_size=2, seed=5,
                  device=CPU)
    full = VerticalBoosting(p).fit(X[:, :3], y, [X[:, 3:]])
    sigs = [t.signature() for t in full.trees]
    assert len(sigs) == 6
    r = VerticalBoosting(p)
    score = r.begin_fit(X[:, :3], y, [X[:, 3:]])
    s1 = r.boost_round(0, score)
    s2 = r.boost_round(1, s1)
    assert len(r.trees) == 4 and len(r.stats.tree_seconds) == 2
    with pytest.raises(RuntimeError, match="expects 2 trees"):
        r.boost_round(1, s1)
    r.rollback_to_round(1)
    assert len(r.trees) == 2 and len(r.tree_class) == 2
    assert len(r.stats.tree_seconds) == 1
    assert r.boost_round(1, s1).tobytes() == s2.tobytes()
    r.finish_fit(r.boost_round(2, s2))
    assert [t.signature() for t in r.trees] == sigs
    np.testing.assert_array_equal(r.train_score_, full.train_score_)


def test_forest_bags_are_the_jax_draws(monkeypatch):
    """``forest_bags`` gives the bags the JAX boosting loop hands its
    grower, round by round (seen through a spy on the JAX
    ``grow_forest``)."""
    import repro.core.boosting as jax_boosting
    from repro_torch.core.boosting import forest_bags
    seen = []
    grow = jax_boosting.grow_forest

    def spy(ctx, bags, *a, **k):
        seen.append(bags)
        return grow(ctx, bags, *a, **k)

    monkeypatch.setattr(jax_boosting, "grow_forest", spy)
    X, y = _data(n=120, seed=6)
    kw = dict(n_trees=3, max_depth=1, n_bins=8, forest_size=3, seed=4)
    JaxBoosting(JaxParams(**kw)).fit(X[:, :3], y, [X[:, 3:]])
    assert len(seen) == 3
    p = SBTParams(device=CPU, **kw)
    for t, bags in enumerate(seen):
        mine = forest_bags(p, t, len(y))
        assert len(mine) == 3
        for a, b in zip(mine, bags):
            np.testing.assert_array_equal(a, b)
            assert len(a) == 96                 # round(0.8 * 120)


def test_forest_subsample_one_bags_every_row():
    """``forest_subsample=1.0`` gives every member every selected row, as
    in the JAX package: the members then differ only by their host
    shuffles, and the fit still equals JAX's."""
    X, y = _data(n=150, seed=4)
    kw = dict(n_trees=1, max_depth=2, n_bins=8, forest_size=2,
              forest_subsample=1.0, seed=2)
    tm = VerticalBoosting(SBTParams(device=CPU, **kw)).fit(X[:, :3], y,
                                                           [X[:, 3:]])
    jm = JaxBoosting(JaxParams(**kw)).fit(X[:, :3], y, [X[:, 3:]])
    assert [t.signature() for t in tm.trees] == \
        [t.signature() for t in jm.trees]
    assert tm.channel.summary() == jm.channel.summary()
    np.testing.assert_array_equal(tm.train_score_, jm.train_score_)
