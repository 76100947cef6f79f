"""The port's training against the JAX package, on the CPU.

``repro_torch.core.VerticalBoosting`` (plain and affine ciphers,
``device="cpu"``) and ``repro.core.VerticalBoosting`` fit the same rows,
made with numpy from a seed, on the shapes of ``tests/test_gbdt.py``
(the affine ones with ``key_bits=256``, ``precision=20``).  Equal means
equal: the
same trees (``FederatedTree.signature()``, leaf weights to the bit), the
same ``predict_score``/``predict_proba``, the same ``channel.summary()``
after the fit and after scoring, and the same integer ``Stats`` counters.
The port's federated fit also equals its own ``LocalGBDT``; a model the
port trained exports to the format the JAX package loads, and a JAX
export serves the port's scores; every option the port does not run yet
raises ``NotImplementedError``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import LocalGBDT as JaxLocal
from repro.core import SBTParams as JaxParams
from repro.core import VerticalBoosting as JaxBoosting
from repro.core import mo_encoding as jax_mo
from repro.core.tree import MOCodec as JaxMOCodec
from repro.core.tree import NoPackCodec as JaxNoPackCodec
from repro.serving import FederatedPredictor as JaxPredictor
from repro.serving import PackedEnsemble as JaxEnsemble
from repro.serving import export_model as jax_export_model
from repro.serving import load_ensemble as jax_load_ensemble
from repro.serving.packed import pack_guest as jax_pack_guest

from repro_torch.core import LocalGBDT, SBTParams, VerticalBoosting
from repro_torch.core import mo_encoding
from repro_torch.core.he import get_cipher
from repro_torch.core.tree import MOCodec, NoPackCodec
from repro_torch.serving import (FederatedPredictor, PackedEnsemble,
                                 export_model, host_half_from_keys,
                                 load_ensemble, pack_guest)

torch.set_num_threads(1)

CPU = "cpu"


def _data(n=400, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    w = rng.normal(0, 1, d)
    y = (X @ w + 0.3 * rng.normal(0, 1, n) > 0).astype(np.float64)
    return X, y


def _int_stats(stats):
    return {k: v for k, v in stats.as_dict().items()
            if isinstance(v, int) and not isinstance(v, bool)}


def _assert_same_fit(tm, jm, Xg, Xh):
    assert len(tm.trees) == len(jm.trees)
    for a, b in zip(tm.trees, jm.trees):
        assert a.signature() == b.signature()
        assert a.host_tables == b.host_tables
    assert tm.channel.summary() == jm.channel.summary()
    assert _int_stats(tm.stats) == _int_stats(jm.stats)
    assert tm.init_score == jm.init_score
    np.testing.assert_array_equal(tm.train_score_, jm.train_score_)
    np.testing.assert_array_equal(tm.predict_proba(Xg, Xh),
                                  jm.predict_proba(Xg, Xh))
    np.testing.assert_array_equal(tm.predict_score(Xg, Xh),
                                  jm.predict_score(Xg, Xh))
    assert tm.channel.summary() == jm.channel.summary()
    assert tm.stats.n_predict_roundtrips == jm.stats.n_predict_roundtrips


AFFINE = dict(cipher="affine", key_bits=256, precision=20)

# the shapes of tests/test_gbdt.py: (guest columns, host column blocks,
# SBTParams, rows) -- :23 one host, :54 two hosts, the legacy ablation,
# and :33 the affine cipher (one host and two)
SHAPES = {
    "one_host": ((0, 3), [(3, 6)],
                 dict(n_trees=4, max_depth=3, n_bins=16), 400),
    "two_hosts": ((0, 2), [(2, 4), (4, 6)],
                  dict(n_trees=3, max_depth=3, n_bins=16), 400),
    "legacy_ablation": ((0, 3), [(3, 6)],
                        dict(n_trees=2, max_depth=3, n_bins=16,
                             packing=False, histogram_subtraction=False,
                             compression=False), 400),
    "deep_min_leaf": ((0, 2), [(2, 6)],
                      dict(n_trees=2, max_depth=5, n_bins=32, min_leaf=20,
                           learning_rate=0.1, seed=3, key_bits=512), 400),
    "affine_one_host": ((0, 3), [(3, 6)],
                        dict(n_trees=3, max_depth=3, n_bins=16, **AFFINE),
                        300),
    "affine_two_hosts": ((0, 2), [(2, 4), (4, 6)],
                         dict(n_trees=3, max_depth=3, n_bins=16, seed=2,
                              **AFFINE), 400),
}


def _split(X, guest, hosts):
    return X[:, guest[0]:guest[1]], [X[:, a:b] for a, b in hosts]


@pytest.fixture(scope="module", params=sorted(SHAPES))
def fitted(request):
    guest, hosts, kw, n = SHAPES[request.param]
    kw = {"cipher": "plain", **kw}
    X, y = _data(n=n)
    Xg, Xh = _split(X, guest, hosts)
    jm = JaxBoosting(JaxParams(**kw)).fit(Xg, y, Xh)
    tm = VerticalBoosting(SBTParams(device=CPU, **kw)).fit(Xg, y, Xh)
    return dict(name=request.param, X=X, y=y, Xg=Xg, Xh=Xh, jm=jm, tm=tm,
                kw=kw)


def test_port_fit_equals_jax_fit(fitted):
    tm, jm = fitted["tm"], fitted["jm"]
    # the training path ran: one layer launch and one split round-trip per
    # (tree, layer, host) at most, and one encrypted batch per tree
    n_hosts = len(fitted["Xh"])
    assert 0 < tm.stats.n_hist_launches <= \
        fitted["kw"]["n_trees"] * fitted["kw"]["max_depth"] * n_hosts
    assert tm.stats.n_split_roundtrips == jm.stats.n_split_roundtrips
    assert tm.channel.msgs["enc_gh"] == fitted["kw"]["n_trees"] * n_hosts
    _assert_same_fit(tm, jm, fitted["Xg"], fitted["Xh"])
    # fresh rows too, and the per-node oracle path
    X2, _ = _data(n=237, seed=5)
    Xg2, Xh2 = _split(X2, *SHAPES[fitted["name"]][:2])
    np.testing.assert_array_equal(tm.predict_score(Xg2, Xh2),
                                  jm.predict_score(Xg2, Xh2))
    np.testing.assert_array_equal(tm.predict_score(Xg2, Xh2, packed=False),
                                  jm.predict_score(Xg2, Xh2, packed=False))
    np.testing.assert_array_equal(tm.predict_score(Xg2, Xh2, packed=False),
                                  tm.predict_score(Xg2, Xh2))


def test_port_federated_plain_equals_port_local():
    """Paper Table 3 'lossless' claim, within the port."""
    X, y = _data()
    loc = LocalGBDT(SBTParams(n_trees=4, max_depth=3, n_bins=16,
                              device=CPU)).fit(X, y)
    fed = VerticalBoosting(SBTParams(n_trees=4, max_depth=3, n_bins=16,
                                     cipher="plain", device=CPU)
                           ).fit(X[:, :3], y, [X[:, 3:]])
    np.testing.assert_array_equal(fed.predict_proba(X[:, :3], [X[:, 3:]]),
                                  loc.predict_proba(X))
    jloc = JaxLocal(JaxParams(n_trees=4, max_depth=3, n_bins=16)).fit(X, y)
    assert [t.signature() for t in loc.trees] == \
        [t.signature() for t in jloc.trees]
    np.testing.assert_array_equal(loc.predict_proba(X), jloc.predict_proba(X))
    assert loc.stats.n_hist_launches == 0 and loc.channel.summary() == \
        jloc.channel.summary()


def test_port_trained_model_exports_to_jax(fitted, tmp_path):
    tm = fitted["tm"]
    Xg, Xh = fitted["Xg"], fitted["Xh"]
    out = export_model(PackedEnsemble.from_model(tm, device=CPU),
                       str(tmp_path / "port_model"))
    back = jax_load_ensemble(out)
    want = tm.predict_score(Xg, Xh)
    np.testing.assert_array_equal(
        JaxPredictor(back.guest, back.hosts).predict_score(Xg, Xh), want)
    # and the same files the JAX package writes for its own fit
    jout = jax_export_model(JaxEnsemble.from_model(fitted["jm"]),
                            str(tmp_path / "jax_model"))
    tens = load_ensemble(jout, device=CPU)
    np.testing.assert_array_equal(
        FederatedPredictor(tens.guest, tens.hosts,
                           device=CPU).predict_score(Xg, Xh), want)


def test_pack_guest_and_host_half_from_keys(fitted):
    tm = fitted["tm"]
    guest, keys = pack_guest(tm, device=CPU)
    ens = PackedEnsemble.from_model(tm, device=CPU)
    assert torch.equal(guest.step, ens.guest.step)
    assert torch.equal(guest.leaf_w, ens.guest.leaf_w)
    jguest, jkeys = jax_pack_guest(fitted["jm"])
    assert keys == jkeys
    np.testing.assert_array_equal(guest.step.numpy(), jguest.step)
    for hid, hk in enumerate(keys):
        half = host_half_from_keys(
            hid, hk, [t.host_tables[hid] for t in tm.trees],
            tm.host_data[hid].thresholds, tm.params.n_bins, device=CPU)
        assert torch.equal(half.table.fid, ens.hosts[hid].table.fid)
        assert torch.equal(half.table.bid, ens.hosts[hid].table.bid)


def test_refit_and_round_replay_are_bit_identical():
    X, y = _data(n=300, seed=2)
    p = SBTParams(n_trees=3, max_depth=3, n_bins=16, device=CPU)
    m = VerticalBoosting(p).fit(X[:, :2], y, [X[:, 2:]])
    sigs = [t.signature() for t in m.trees]
    ledger = m.channel.summary()
    m.fit(X[:, :2], y, [X[:, 2:]])                 # a refit starts afresh
    assert [t.signature() for t in m.trees] == sigs
    assert m.channel.summary() == ledger
    # replay round 2 from its boundary
    r = VerticalBoosting(p)
    score = r.begin_fit(X[:, :2], y, [X[:, 2:]])
    for t in range(2):
        score = r.boost_round(t, score)
    with pytest.raises(RuntimeError, match="rollback"):
        r.boost_round(1, score)
    r.boost_round(2, score)
    r.rollback_to_round(2)
    r.finish_fit(r.boost_round(2, score))
    assert [t.signature() for t in r.trees] == sigs


def test_codecs_match_jax():
    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, 50)
    h = rng.uniform(0, 0.25, 50)
    tc, jc = NoPackCodec.plan(g), JaxNoPackCodec.plan(g)
    np.testing.assert_array_equal(tc.encode_plain(g, h),
                                  jc.encode_plain(g, h))
    G, H = rng.normal(0, 1, (50, 3)), rng.uniform(0, 0.25, (50, 3))
    plan = mo_encoding.plan_mo_packing(G, H, 50, 1023)
    jplan = jax_mo.plan_mo_packing(G, H, 50, 1023)
    assert repr(plan) == repr(jplan)
    tm, jm = MOCodec(plan), JaxMOCodec(jplan)
    plain = tm.encode_plain(G, H)
    np.testing.assert_array_equal(plain, jm.encode_plain(G, H))
    ints = [[sum(int(v) << (8 * j) for j, v in enumerate(row))
             for row in plain[i]] for i in range(4)]
    counts = np.ones(4, np.int64)
    for a, b in zip(tm.decode(ints, counts), jm.decode(ints, counts)):
        np.testing.assert_array_equal(a, b)


UNPORTED = {
    "cipher_paillier": dict(cipher="paillier"),
    "objective_multiclass": dict(objective="multiclass", n_classes=3),
    "objective_mo": dict(objective="mo", n_classes=3),
    "tree_mode_mix": dict(tree_mode="mix"),
    "tree_mode_layered": dict(tree_mode="layered"),
    "goss": dict(goss=True),
    "sparse": dict(sparse=True),
    "pipeline": dict(pipeline=True),
    # round-forests run, but not with GOSS's shared selection yet
    "forest_goss": dict(goss=True, forest_size=2),
    "mesh": dict(mesh=object()),
    "row_block": dict(row_block=128),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_options_raise(case):
    params = SBTParams(device=CPU, **UNPORTED[case])
    option = next(iter(UNPORTED[case]))
    with pytest.raises(NotImplementedError, match=f"{option}.*ROADMAP"):
        VerticalBoosting(params)
    if case.startswith("cipher"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_cipher(UNPORTED[case]["cipher"], key_bits=256, seed=0)


def test_affine_trained_model_serves_like_predict_tree():
    """The ("binary", "affine") case of tests/test_serving.py's export
    round-trip: the port's affine-trained model, served through a fresh
    ``FederatedPredictor``, scores as ``predict_tree`` does and as the JAX
    package's model does."""
    X, y = _data(n=350, seed=4)
    kw = dict(n_trees=3, max_depth=3, n_bins=16, **AFFINE)
    tm = VerticalBoosting(SBTParams(device=CPU, **kw)).fit(X[:, :3], y,
                                                           [X[:, 3:]])
    jm = JaxBoosting(JaxParams(**kw)).fit(X[:, :3], y, [X[:, 3:]])
    ens = PackedEnsemble.from_model(tm, device=CPU)
    served = FederatedPredictor(ens.guest, ens.hosts,
                                device=CPU).predict_score(X[:, :3],
                                                          [X[:, 3:]])
    np.testing.assert_array_equal(
        served, tm.predict_score(X[:, :3], [X[:, 3:]], packed=False))
    np.testing.assert_array_equal(served,
                                  jm.predict_score(X[:, :3], [X[:, 3:]]))
    assert [t.signature() for t in tm.trees] == \
        [t.signature() for t in jm.trees]


# tuning knobs of the modes above: the port takes each one only together
# with the code that reads it, so none is accepted and then ignored
UNREAD = ("top_rate", "other_rate", "guest_depth", "host_depth",
          "trees_per_party")


@pytest.mark.parametrize("field", UNREAD)
def test_knobs_of_unported_modes_are_not_accepted(field):
    assert field in {f.name for f in dataclasses.fields(JaxParams)}
    with pytest.raises(TypeError, match=field):
        SBTParams(device=CPU, **{field: 1})


def test_numpy_copies_and_plain_cipher_match_jax():
    """The port's copies of the numpy protocol pieces (GOSS, the losses)
    and the plain cipher's constants give the JAX package's values."""
    from repro.core.goss import goss_sample as jax_goss
    from repro.core.he.plain import PlainCipher as JaxPlain
    from repro.core.loss import LogLoss as JaxLogLoss
    from repro.core.loss import SoftmaxLoss as JaxSoftmax
    from repro_torch.core.goss import goss_sample
    from repro_torch.core.he.plain import PlainCipher
    from repro_torch.core.loss import LogLoss, SoftmaxLoss
    rng = np.random.default_rng(4)
    g = rng.normal(0, 1, 300)
    for top, other in ((0.2, 0.1), (0.3, 0.0)):
        idx, w = goss_sample(g, top, other, np.random.default_rng(1))
        jidx, jw = jax_goss(g, top, other, np.random.default_rng(1))
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(w, jw)
    y = (rng.random(300) > 0.5).astype(np.float64)
    s = rng.normal(0, 1, 300)
    assert LogLoss.init_score(y) == JaxLogLoss.init_score(y)
    for a, b in zip(LogLoss.grad_hess(y, s), JaxLogLoss.grad_hess(y, s)):
        np.testing.assert_array_equal(a, b)
    S = rng.normal(0, 1, (300, 3))
    yk = rng.integers(0, 3, 300).astype(np.float64)
    for a, b in zip(SoftmaxLoss(3).grad_hess(yk, S),
                    JaxSoftmax(3).grad_hess(yk, S)):
        np.testing.assert_array_equal(a, b)
    tc, jc = PlainCipher(bits=1024), JaxPlain(bits=1024)
    assert (tc.Ln, tc.plaintext_bits, tc.hist_width) == \
        (jc.Ln, jc.plaintext_bits, jc.hist_width) == (128, 1023, 131)
    zero = tc.zero((2, 3), device="cpu")
    assert zero.dtype == torch.int32
    np.testing.assert_array_equal(zero.numpy(), np.asarray(jc.zero((2, 3))))
    x = torch.from_numpy(rng.integers(0, 256, (4, 3, 20)).astype(np.int32))
    np.testing.assert_array_equal(tc.encrypt_limbs(x).numpy(),
                                  np.asarray(jc.encrypt_limbs(x.numpy())))
    np.testing.assert_array_equal(
        tc.mul_pow2(tc.encrypt_limbs(x), 138).numpy(),
        np.asarray(jc.mul_pow2(jc.encrypt_limbs(x.numpy()), 138)))
