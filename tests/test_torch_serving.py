"""The port's serving path against the JAX serving engine, on the CPU.

JAX-trained models (plain cipher) are exported by the JAX package and
served by the port: scores, ``predict_proba``, the ``predict_*`` ledger
and the round-trip count must be EQUAL, not close — routing is integer
work and the float64 adds replay the same per-tree order.  Exports
cross-load both ways, corrupt exports raise ``ValueError``, and the
committed fixtures that ``chip_smoke.py`` holds the card to must still be
what both packages serve.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.core import SBTParams, VerticalBoosting
from repro.core.binning import apply_binning as jax_apply_binning
from repro.serving import FederatedPredictor as JaxPredictor
from repro.serving import PackedEnsemble as JaxEnsemble
from repro.serving import export_model as jax_export_model
from repro.serving import load_ensemble as jax_load_ensemble
from repro.serving.export import _guest_payload, _host_payload

from repro_torch.core.party import Channel, Stats
from repro_torch.serving import (FederatedPredictor, PackedEnsemble,
                                 export_model, load_ensemble, load_guest,
                                 load_host)
from repro_torch.serving.engine import _packed_bits, _route

torch.set_num_threads(1)

CPU = "cpu"
FIXTURES = os.path.join(os.path.dirname(__file__), "..", "src",
                        "repro_torch", "fixtures")


def _data(n=400, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    w = rng.normal(0, 1, d)
    y = (X @ w + 0.3 * rng.normal(0, 1, n) > 0).astype(np.float64)
    return X, y


def _multi_labels(X, seed=0):
    rng = np.random.default_rng(seed)
    s = X @ rng.normal(0, 1, X.shape[1])
    return ((s > np.quantile(s, 0.33)).astype(float)
            + (s > np.quantile(s, 0.66)).astype(float))


# guest features, then each host's block
SPLITS = {1: [(0, 2), (2, 6)], 2: [(0, 2), (2, 4), (4, 6)]}
MODELS = {"binary": ("binary", 1), "binary_2hosts": ("binary", 2),
          "multiclass": ("multiclass", 1), "mo": ("mo", 1)}


def _parts(X, n_hosts):
    (g0, g1), *hs = SPLITS[n_hosts]
    return X[:, g0:g1], [X[:, a:b] for a, b in hs]


@pytest.fixture(scope="module", params=sorted(MODELS))
def exported(request, tmp_path_factory):
    """A JAX-trained model (``tests/test_gbdt.py`` shapes, plain cipher),
    its JAX packed halves, and its JAX export on disk."""
    objective, n_hosts = MODELS[request.param]
    X, y = _data()
    kw = {}
    if objective != "binary":
        y = _multi_labels(X)
        kw = dict(objective=objective, n_classes=3)
    Xg, Xh = _parts(X, n_hosts)
    model = VerticalBoosting(SBTParams(n_trees=3, max_depth=3, n_bins=16,
                                       cipher="plain", **kw)).fit(Xg, y, Xh)
    ens = JaxEnsemble.from_model(model)
    out = str(tmp_path_factory.mktemp(request.param) / "jax_export")
    jax_export_model(ens, out)
    return dict(name=request.param, n_hosts=n_hosts, ens=ens, out=out)


def _fresh_rows(n_hosts, n=237, seed=3):       # n % 8 != 0
    X, _ = _data(n=n, seed=seed)
    return _parts(X, n_hosts)


def test_port_serves_jax_export_bit_identical(exported):
    Xg, Xh = _fresh_rows(exported["n_hosts"])
    ens = exported["ens"]
    jpred = JaxPredictor(ens.guest, ens.hosts)
    tens = load_ensemble(exported["out"], device=CPU)
    tpred = FederatedPredictor(tens.guest, tens.hosts, device=CPU)
    for _ in range(2):                          # two batches, same ledgers
        want = jpred.predict_score(Xg, Xh)
        got = tpred.predict_score(Xg, Xh)
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpred.predict_proba(Xg, Xh),
                                  jpred.predict_proba(Xg, Xh))
    assert tpred.channel.summary() == jpred.channel.summary()
    assert set(tpred.channel.summary()) == {"predict_req", "predict_bits"}
    assert tpred.stats.n_predict_roundtrips == \
        jpred.stats.n_predict_roundtrips == 3 * exported["n_hosts"]
    assert tpred.stats.n_predict_batches == jpred.stats.n_predict_batches


def test_port_serves_binned_batch_bit_identical(exported):
    """``predict_score_binned`` on bins the JAX package computed."""
    Xg, Xh = _fresh_rows(exported["n_hosts"], n=64, seed=11)
    ens = exported["ens"]
    gb = jax_apply_binning(Xg, _binner(ens.guest.thresholds))
    hb = [jax_apply_binning(x, _binner(h.thresholds))
          for x, h in zip(Xh, ens.hosts)]
    want = JaxPredictor(ens.guest, ens.hosts).predict_score_binned(gb, hb)
    tens = load_ensemble(exported["out"], device=CPU)
    tpred = FederatedPredictor(tens.guest, tens.hosts, device=CPU)
    np.testing.assert_array_equal(tpred.predict_score_binned(gb, hb), want)


def _binner(thr):
    from repro.core.binning import BinnedData
    return BinnedData(bins=np.zeros((0, thr.shape[0]), np.int32),
                      thresholds=thr, n_bins=thr.shape[1] + 1)


def test_port_export_loads_and_serves_in_jax(exported, tmp_path):
    tens = load_ensemble(exported["out"], device=CPU)
    out = export_model(tens, str(tmp_path / "torch_export"))
    back = jax_load_ensemble(out)
    Xg, Xh = _fresh_rows(exported["n_hosts"], seed=4)
    ens = exported["ens"]
    np.testing.assert_array_equal(
        JaxPredictor(back.guest, back.hosts).predict_score(Xg, Xh),
        JaxPredictor(ens.guest, ens.hosts).predict_score(Xg, Xh))
    # the files themselves: same manifests, same arrays, same dtypes
    for party in sorted(os.listdir(exported["out"])):
        with open(os.path.join(exported["out"], party,
                               "manifest.json")) as f:
            want = json.load(f)
        with open(os.path.join(out, party, "manifest.json")) as f:
            assert json.load(f) == want
        with np.load(os.path.join(exported["out"], party, "arrays.npz")) \
                as a, np.load(os.path.join(out, party, "arrays.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_from_numpy_equals_load_ensemble(exported):
    ens = exported["ens"]
    g = {**_guest_payload(ens.guest)[0], **_guest_payload(ens.guest)[1]}
    hs = [{**_host_payload(h)[0], **_host_payload(h)[1]} for h in ens.hosts]
    mem = PackedEnsemble.from_numpy(g, hs, device=CPU)
    disk = load_ensemble(exported["out"], device=CPU)
    _assert_same_ensemble(mem, disk)
    assert mem.guest.step.dtype == torch.int32
    assert mem.guest.leaf_w.dtype == torch.float64
    assert mem.guest.thresholds.dtype == torch.float32
    assert mem.guest.step.device.type == CPU


def _assert_same_ensemble(a, b):
    fa, fb = vars(a.guest), vars(b.guest)
    assert fa.keys() == fb.keys()
    for k in fa:
        if k == "guest":
            for t, u in zip(vars(fa[k]).values(), vars(fb[k]).values()):
                assert torch.equal(t, u)
        elif torch.is_tensor(fa[k]):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k])
        else:
            np.testing.assert_array_equal(fa[k], fb[k])
            assert type(fa[k]) is type(fb[k])
    assert len(a.hosts) == len(b.hosts)
    for ha, hb in zip(a.hosts, b.hosts):
        assert ha.hid == hb.hid and ha.n_bins == hb.n_bins
        assert torch.equal(ha.thresholds, hb.thresholds)
        assert torch.equal(ha.table.fid, hb.table.fid)
        assert torch.equal(ha.table.bid, hb.table.bid)


def _rewrite_json(path, edit):
    with open(path) as f:
        man = json.load(f)
    edit(man)
    with open(path, "w") as f:
        json.dump(man, f)


def _truncate(path):
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2])


def _set(key, value):
    def edit(man):
        man[key] = value
    return edit


def _drop_array(name):
    def edit(man):
        del man["arrays"][name]
    return edit


def _reshape(name):
    def edit(man):
        man["arrays"][name]["shape"] = [1, 2]
    return edit


def _retype_leaf_w(party_dir):
    az = os.path.join(party_dir, "arrays.npz")
    with np.load(az) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["leaf_w"] = arrays["leaf_w"].astype(np.float32)
    np.savez_compressed(az, **arrays)


CORRUPTIONS = {
    "truncated_json": ("guest", lambda d: _truncate(
        os.path.join(d, "manifest.json")), "corrupt"),
    "wrong_role": ("guest", lambda d: _rewrite_json(
        os.path.join(d, "manifest.json"), _set("role", "host")), "role"),
    "bad_format": ("host0", lambda d: _rewrite_json(
        os.path.join(d, "manifest.json"), _set("format", "other")),
        "format"),
    "shape": ("guest", lambda d: _rewrite_json(
        os.path.join(d, "manifest.json"), _reshape("step")), "shape"),
    "missing_array": ("guest", lambda d: _rewrite_json(
        os.path.join(d, "manifest.json"), _drop_array("roots")),
        "missing array"),
    "missing_value": ("guest", lambda d: _rewrite_json(
        os.path.join(d, "manifest.json"), lambda m: m.pop("depth")),
        "missing"),
    "node_count": ("guest", lambda d: _rewrite_json(
        os.path.join(d, "manifest.json"), _set("n_nodes", 3)),
        "tree/node counts"),
    "host_hid": ("host0", lambda d: _rewrite_json(
        os.path.join(d, "manifest.json"), lambda m: m.pop("hid")),
        "missing"),
    "dtype": ("guest", _retype_leaf_w, "dtype"),
    "truncated_npz": ("guest", lambda d: _truncate(
        os.path.join(d, "arrays.npz")), "corrupt serving arrays"),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_corrupt_export_raises(tmp_path, case):
    X, y = _data(n=250, seed=6)
    m = VerticalBoosting(SBTParams(n_trees=2, max_depth=2, n_bins=8)).fit(
        X[:, :3], y, [X[:, 3:]])
    out = str(tmp_path / "model")
    jax_export_model(m, out)
    party, corrupt, match = CORRUPTIONS[case]
    corrupt(os.path.join(out, party))
    load = load_guest if party == "guest" else load_host
    with pytest.raises(ValueError, match=match):
        load(os.path.join(out, party), device=CPU)
    with pytest.raises(ValueError, match=match):
        load_ensemble(out, device=CPU)


def test_export_audit_and_atomic_overwrite(exported, tmp_path):
    tens = load_ensemble(exported["out"], device=CPU)
    out = str(tmp_path / "m")
    export_model(tens, out)
    export_model(tens, out)                  # overwrite in place
    assert sorted(os.listdir(tmp_path)) == ["m"]
    with pytest.raises(TypeError, match="PackedEnsemble"):
        export_model(tens.guest, str(tmp_path / "x"))


@pytest.mark.parametrize("manifest,arrays,match", [
    ({"role": "guest", "n_bins": 4}, {"g": np.zeros(3)}, "undeclared"),
    ({"role": "host", "extra": {"hess": 1}}, {}, "secret field"),
    ({"role": "guest"}, {"step": np.zeros(2), "labels": np.zeros(2)},
     "undeclared"),
    ({"role": "carol"}, {}, "unknown party role"),
])
def test_export_audit_refuses_secrets(manifest, arrays, match):
    from repro_torch.serving.export import _audit_party
    with pytest.raises(ValueError, match=match):
        _audit_party(manifest, arrays)


def test_predictor_refuses_inconsistent_halves(exported):
    tens = load_ensemble(exported["out"], device=CPU)
    pred = FederatedPredictor(tens.guest, tens.hosts, device=CPU,
                              channel=Channel(), stats=Stats())
    Xg, Xh = _fresh_rows(exported["n_hosts"], n=16)
    with pytest.raises(ValueError, match="host matrices"):
        pred.predict_score(Xg, Xh[:-1])
    with pytest.raises(ValueError, match="expects hosts"):
        FederatedPredictor(tens.guest, tens.hosts[:-1], device=CPU)
    import dataclasses
    bad = dataclasses.replace(tens.guest, guest=dataclasses.replace(
        tens.guest.guest, fid=tens.guest.guest.fid[:-1],
        bid=tens.guest.guest.bid[:-1]))
    with pytest.raises(ValueError, match="guest split table"):
        FederatedPredictor(bad, tens.hosts, device=CPU)


@pytest.mark.parametrize("n", [1, 8, 13, 64, 237])
def test_packed_bits_match_numpy_packbits(n):
    rng = np.random.default_rng(n)
    n_f, k, n_b = 5, 9, 16
    n_pad = 1 << max(n - 1, 1).bit_length()
    n_pad += (-n_pad) % 8
    bins = rng.integers(0, n_b, (n, n_f)).astype(np.int32)
    fid = rng.integers(0, n_f, k)
    bid = rng.integers(0, n_b, k).astype(np.int32)
    bins_T = np.zeros((n_f, n_pad), np.int32)
    bins_T[:, :n] = bins.T
    want = np.packbits(bins_T[fid] <= bid[:, None], axis=1,
                       bitorder="little")
    bins_P = torch.from_numpy(bins_T).view(n_f, n_pad // 8, 8)
    got = _packed_bits(bins_P.permute(0, 2, 1).contiguous(),
                       torch.from_numpy(fid),
                       torch.from_numpy(bid)[:, None])
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_route_without_internal_nodes_stays_on_roots():
    node = torch.tensor([[3, 4]] * 8)
    step = torch.tensor([[i, i] for i in range(5)])
    out = _route(torch.zeros((0, 1), dtype=torch.uint8), step, node, 3)
    assert torch.equal(out, node)


# committed fixtures -> (trees, depth) their guest half must hold
COMMITTED = {"serving_t25_d6": (25, 6),
             "serving_branches/multiclass_2hosts": (12, 4),
             "serving_branches/mo": (4, 4)}


def _fixture_batch(ref, n):
    rng = np.random.default_rng(int(ref["seed"]))
    X = rng.normal(float(ref["loc"]), float(ref["scale"]),
                   (int(ref["n"]), int(ref["d"]))).astype(np.float32)[:n]
    parts = [X[:, a:b] for a, b in zip(ref["bounds"][:-1], ref["bounds"][1:])]
    return parts[0], parts[1:]


@pytest.mark.parametrize("name", sorted(COMMITTED))
def test_committed_fixture_still_agrees(name):
    """The exports and scores ``chip_smoke.py`` holds the card to: the
    first 4096 rows, served by the JAX package and by the port on the
    CPU."""
    path = os.path.join(FIXTURES, name)
    with np.load(os.path.join(path, "reference.npz")) as z:
        ref = {k: z[k] for k in z.files}
    Xg, Xh = _fixture_batch(ref, 4096)
    assert Xg.shape[1] == int(ref["n_guest"])
    jens = jax_load_ensemble(path)
    np.testing.assert_array_equal(
        JaxPredictor(jens.guest, jens.hosts).predict_score(Xg, Xh),
        ref["scores"][:4096])
    tens = load_ensemble(path, device=CPU)
    assert (tens.guest.n_trees, tens.guest.depth) == COMMITTED[name]
    np.testing.assert_array_equal(
        FederatedPredictor(tens.guest, tens.hosts,
                           device=CPU).predict_score(Xg, Xh),
        ref["scores"][:4096])
