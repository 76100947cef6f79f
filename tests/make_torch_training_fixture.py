"""Regenerate the training references that ``chip_smoke.py`` holds the
port to.

The machine with the card runs the port only, with no JAX, so the JAX
package's answer is computed here on the CPU and committed.  Each fixture
is a directory under ``src/repro_torch/fixtures/`` with

* ``reference.json``: the run (``data``: ``synthetic_tabular`` arguments
  and the column edges of the guest and each host; ``params``: the
  ``SBTParams`` fields that differ from the defaults, which the two
  packages share), every tree's ``FederatedTree.signature()`` (the
  float64 leaf weight as the hex of its bytes), ``channel.summary()``
  after ``fit`` and again after ``predict_score``, and the integer
  ``Stats`` counters after ``fit``;
* ``scores.npz``: ``predict_score`` over the training rows (float64).

Fixtures:

* ``train_scale_plain``: the scale shape of
  ``benchmarks/bench_tree_build.py`` (``SCALE``):
  ``synthetic_tabular(65536, 16, seed=0)``, 2 guest and 14 host features,
  ``SBTParams(n_trees=3, max_depth=4, n_bins=32, seed=1, cipher="plain")``
  (key_bits 1024);
* ``train_two_hosts_plain``: the shape of ``tests/test_gbdt.py``'s
  two-host case: ``synthetic_tabular(400, 6, seed=0)``, columns 0-1 on the
  guest, 2-3 and 4-5 on two hosts, 3 trees of ``max_depth=3``,
  ``n_bins=16``;
* ``train_scale_affine``: ``train_scale_plain``'s run with
  ``cipher="affine"`` (key_bits 1024, the default precision);
* ``train_two_hosts_affine``: ``train_two_hosts_plain``'s rows and
  parties, 3 trees of ``max_depth=3``, ``n_bins=16``, ``cipher="affine"``
  with ``key_bits=256`` and ``precision=20`` (the affine case of
  ``tests/test_gbdt.py``).

Run from the repo root (not collected by pytest), naming the fixtures to
write (default: all):

    PYTHONPATH=src python tests/make_torch_training_fixture.py \\
        [train_scale_plain] [train_two_hosts_plain] \\
        [train_scale_affine] [train_two_hosts_affine] \\
        [train_forest4_affine] [train_two_hosts_forest]
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys

import numpy as np

import repro.core.boosting as jax_boosting
from repro.core import SBTParams, VerticalBoosting
from repro.data import synthetic_tabular

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "..", "src", "repro_torch", "fixtures")

FIXTURE_RUNS = {
    "train_scale_plain": (
        dict(n=65536, d=16, seed=0, bounds=[0, 2, 16]),
        dict(n_trees=3, max_depth=4, n_bins=32, seed=1, cipher="plain")),
    "train_two_hosts_plain": (
        dict(n=400, d=6, seed=0, bounds=[0, 2, 4, 6]),
        dict(n_trees=3, max_depth=3, n_bins=16, cipher="plain")),
    "train_scale_affine": (
        dict(n=65536, d=16, seed=0, bounds=[0, 2, 16]),
        dict(n_trees=3, max_depth=4, n_bins=32, seed=1, cipher="affine")),
    "train_two_hosts_affine": (
        dict(n=400, d=6, seed=0, bounds=[0, 2, 4, 6]),
        dict(n_trees=3, max_depth=3, n_bins=16, cipher="affine",
             key_bits=256, precision=20)),
    "train_forest4_affine": (
        dict(n=65536, d=16, seed=0, bounds=[0, 2, 16]),
        dict(n_trees=2, max_depth=4, n_bins=32, seed=1, cipher="affine",
             key_bits=512, precision=24, forest_size=4)),
    "train_two_hosts_forest": (
        dict(n=400, d=6, seed=0, bounds=[0, 2, 4, 6]),
        dict(n_trees=2, max_depth=3, n_bins=16, seed=11, cipher="plain",
             forest_size=3)),
}


def split(X, bounds):
    """The guest's columns and the list of each host's columns."""
    parts = [X[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    return parts[0], parts[1:]


def signature_json(tree) -> list:
    """``tree.signature()`` as JSON: the leaf weight's float64 bytes in
    hex, so the comparison stays exact."""
    return [list(row[:8]) + [None if row[8] is None else row[8].hex()]
            for row in tree.signature()]


def int_stats(stats) -> dict:
    return {k: v for k, v in stats.as_dict().items()
            if isinstance(v, int) and not isinstance(v, bool)}


def bags_digest(bags) -> str:
    """sha256 of one round's member bags (row positions), as int64."""
    return hashlib.sha256(np.stack([np.asarray(b, np.int64)
                                    for b in bags]).tobytes()).hexdigest()


@contextlib.contextmanager
def recorded_bags():
    """The digest of every round's bags the JAX grower is handed, in
    order, while the context is open."""
    digests = []
    grow = jax_boosting.grow_forest

    def spy(ctx, bags, *a, **k):
        digests.append(bags_digest(bags))
        return grow(ctx, bags, *a, **k)

    jax_boosting.grow_forest = spy
    try:
        yield digests
    finally:
        jax_boosting.grow_forest = grow


def fit_reference(name: str):
    """The JAX package's fit of one fixture run: (reference dict,
    training-row scores)."""
    data, params = FIXTURE_RUNS[name]
    X, y = synthetic_tabular(data["n"], data["d"], seed=data["seed"])
    Xg, Xh = split(X, data["bounds"])
    with recorded_bags() as bags:
        model = VerticalBoosting(SBTParams(**params)).fit(Xg, y, Xh)
    fit_summary = model.channel.summary()
    stats = int_stats(model.stats)
    scores = model.predict_score(Xg, Xh)
    ref = dict(data=data, params=params,
               signatures=[signature_json(t) for t in model.trees],
               summary_fit=fit_summary,
               summary_predict=model.channel.summary(), stats=stats)
    if params.get("forest_size", 1) > 1:
        ref["bags_sha256"] = bags
    return ref, np.asarray(scores, np.float64)


def write(name: str) -> None:
    ref, scores = fit_reference(name)
    out = os.path.normpath(os.path.join(FIXTURES, name))
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "reference.json"), "w") as f:
        json.dump(ref, f, indent=1)
    np.savez_compressed(os.path.join(out, "scores.npz"), scores=scores)
    print(f"wrote {out}: {len(ref['signatures'])} trees, "
          f"n_hist_launches={ref['stats']['n_hist_launches']}, "
          f"scores[:2]={scores[:2]}")


def main(names):
    # the references pin numpy 2.0's float64 sum order (the port's
    # core/sums.py writes that order out)
    if not np.__version__.startswith("2.0."):
        sys.exit(f"numpy {np.__version__}: the references are made on "
                 f"numpy 2.0")
    for name in names or FIXTURE_RUNS:
        write(name)


if __name__ == "__main__":
    main(sys.argv[1:])
