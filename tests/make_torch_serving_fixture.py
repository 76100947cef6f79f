"""Regenerate the serving fixture that ``chip_smoke.py`` holds the port to.

The machine with the card runs the port only, with no JAX, so the JAX
package's answer is computed here and committed:

* the model of ``benchmarks/bench_serving.py`` (``SHAPE``: plain cipher,
  25 trees, ``max_depth=6``, ``n_bins=32``, ``seed=1``, trained on the
  first 4096 rows of ``synthetic_tabular(65536, 16, seed=0)``, 2 guest and
  14 host features), exported with ``repro.serving.export_model`` to
  ``src/repro_torch/fixtures/serving_t25_d6/`` (``guest/``, ``host0/``);
* ``reference.npz`` beside it: the JAX ``FederatedPredictor`` float64
  scores for all rows of the serving batch, and the batch generator's
  parameters.  The batch is
  ``np.random.default_rng(seed).normal(loc, scale, (n, d)).astype(float32)``
  with the first ``n_guest`` columns on the guest; ``bounds`` holds the
  column edges of the guest and of each host.

Two small models, written under ``src/repro_torch/fixtures/serving_branches/``
the same way, hold the score accumulation's other branches to the JAX
package on the card: ``multiclass_2hosts`` (3 classes, one guest and two
hosts) and ``mo`` (3-output vector leaves), each 4 rounds of
``max_depth=4`` trees, ``n_bins=16``, trained on the first 2048 rows of
``synthetic_tabular(4096, 8, seed=0, task="multiclass", n_classes=3)``,
with reference scores for 8192 rows.

Run from the repo root (not collected by pytest), naming the fixtures to
write (default: all):

    PYTHONPATH=src python tests/make_torch_serving_fixture.py \\
        [serving_t25_d6] [multiclass_2hosts] [mo]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from repro.core import SBTParams, VerticalBoosting
from repro.data import synthetic_tabular
from repro.serving import FederatedPredictor, export_model, load_ensemble

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "..", "src", "repro_torch", "fixtures")

# name -> (directory under fixtures/, training data, model parameters,
#          column edges [guest, host0, ...], serving batch)
MODELS = {
    "serving_t25_d6": (
        "serving_t25_d6",
        dict(n=65536, d=16, task="binary", n_train=4096),
        dict(n_trees=25, max_depth=6, n_bins=32),
        [0, 2, 16], dict(seed=0, loc=0.0, scale=1.0, n=65536)),
    "multiclass_2hosts": (
        "serving_branches/multiclass_2hosts",
        dict(n=4096, d=8, task="multiclass", n_classes=3, n_train=2048),
        dict(n_trees=4, max_depth=4, n_bins=16, objective="multiclass",
             n_classes=3),
        [0, 2, 5, 8], dict(seed=0, loc=0.0, scale=1.0, n=8192)),
    "mo": (
        "serving_branches/mo",
        dict(n=4096, d=8, task="multiclass", n_classes=3, n_train=2048),
        dict(n_trees=4, max_depth=4, n_bins=16, objective="mo",
             n_classes=3),
        [0, 3, 8], dict(seed=0, loc=0.0, scale=1.0, n=8192)),
}


def split(X, bounds):
    """The guest's columns and the list of each host's columns."""
    parts = [X[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    return parts[0], parts[1:]


def write(name):
    sub, data, params, bounds, batch = MODELS[name]
    data = dict(data)
    n_train = data.pop("n_train")
    X, y = synthetic_tabular(seed=0, **data)
    Xg, Xh = split(X[:n_train], bounds)
    model = VerticalBoosting(SBTParams(cipher="plain", seed=1, **params)
                             ).fit(Xg, y[:n_train], Xh)
    out = os.path.normpath(os.path.join(FIXTURES, sub))
    export_model(model, out)

    ens = load_ensemble(out)
    pred = FederatedPredictor(ens.guest, ens.hosts)
    d = bounds[-1]
    rows = np.random.default_rng(batch["seed"]).normal(
        batch["loc"], batch["scale"], (batch["n"], d)).astype(np.float32)
    bg, bh = split(rows, bounds)
    scores = pred.predict_score(bg, bh)
    # the reloaded halves must serve what the live model serves
    np.testing.assert_array_equal(scores, model.predict_score(bg, bh))
    np.savez_compressed(os.path.join(out, "reference.npz"),
                        scores=np.asarray(scores, np.float64),
                        **{k: np.asarray(v) for k, v in batch.items()},
                        d=np.asarray(d), n_guest=np.asarray(bounds[1]),
                        bounds=np.asarray(bounds))
    print(f"wrote {out}: {ens.guest.n_trees} trees, "
          f"{ens.guest.n_nodes} nodes, k_parties="
          f"{ens.guest.k_parties.tolist()}, scores[:2]={scores[:2]}")


def main(names):
    for name in names or MODELS:
        write(name)


if __name__ == "__main__":
    main(sys.argv[1:])
