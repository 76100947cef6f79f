"""The committed training references that ``chip_smoke.py`` holds the card
to, checked on the CPU.

``src/repro_torch/fixtures/train_*`` were written by
``tests/make_torch_training_fixture.py`` from JAX fits, with the plain and
the affine cipher, one tree or a round-forest a round.  Each reference
records the run its maker defines; the small two-host references must
still be what the JAX package fits now; and every reference (the two-host
cases and the 65,536-row scale shapes) must be what the port fits on the
CPU, through the same comparison ``chip_smoke.py`` makes on the card: tree
signatures, scores over the training rows, ``channel.summary()`` after the
fit and after scoring, the integer ``Stats`` counters and, for a
round-forest, each round's member bags, all equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

from make_torch_training_fixture import FIXTURE_RUNS, fit_reference

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

torch.set_num_threads(2)


ALL = (chip_smoke.TRAIN_TWO_HOSTS, chip_smoke.TRAIN_SCALE,
       chip_smoke.TRAIN_TWO_HOSTS_AFFINE, chip_smoke.TRAIN_SCALE_AFFINE,
       chip_smoke.TRAIN_TWO_HOSTS_FOREST, chip_smoke.TRAIN_FOREST4)


def _assert_reference_is_the_jax_fit(name):
    ref, scores = chip_smoke.training_reference(name)
    want, want_scores = fit_reference(name)
    # JSON turns the signature tuples into lists
    assert ref["signatures"] == [[list(r) for r in t]
                                 for t in want["signatures"]]
    assert {k: v for k, v in ref.items() if k != "signatures"} == \
        {k: v for k, v in want.items() if k != "signatures"}
    np.testing.assert_array_equal(scores, want_scores)


def test_two_host_reference_is_the_jax_fit():
    _assert_reference_is_the_jax_fit(chip_smoke.TRAIN_TWO_HOSTS)


def test_affine_two_host_reference_is_the_jax_fit():
    _assert_reference_is_the_jax_fit(chip_smoke.TRAIN_TWO_HOSTS_AFFINE)


def test_forest_two_host_reference_is_the_jax_fit():
    _assert_reference_is_the_jax_fit(chip_smoke.TRAIN_TWO_HOSTS_FOREST)


@pytest.mark.parametrize("name", ALL)
def test_reference_records_the_makers_run(name):
    ref, _ = chip_smoke.training_reference(name)
    data, params = FIXTURE_RUNS[name]
    assert (ref["data"], ref["params"]) == (data, params)
    # the name says the cipher, or the forest width of a plain run
    named = name.split("_")[-1]
    cipher = "plain" if named == "forest" else named
    assert ref["params"]["cipher"] == cipher
    forest = "forest" in name
    assert (ref["params"].get("forest_size", 1) > 1) == forest
    assert ("bags_sha256" in ref) == forest
    if forest:
        assert len(ref["bags_sha256"]) == ref["params"]["n_trees"]


@pytest.mark.parametrize("name", ALL)
def test_port_cpu_fit_equals_committed_reference(name):
    model, bad, _ = chip_smoke.train_and_compare(name, "cpu")
    assert bad == []
    ref, _ = chip_smoke.training_reference(name)
    assert model.stats.n_hist_launches == ref["stats"]["n_hist_launches"] > 0
    assert len(model.host_data) == len(ref["data"]["bounds"]) - 2


def test_compare_training_reports_each_difference():
    ref, scores = chip_smoke.training_reference(chip_smoke.TRAIN_TWO_HOSTS)
    model, bad, _ = chip_smoke.train_and_compare(chip_smoke.TRAIN_TWO_HOSTS,
                                                 "cpu")
    assert bad == []
    stats = dict(ref["stats"], n_hist_launches=-1)
    worse = scores.copy()
    worse[3] += 1e-12
    summary = dict(ref["summary_fit"], extra={"bytes": 1, "msgs": 1})
    bad = chip_smoke.compare_training(ref, scores, model.trees[:2], summary,
                                      stats, worse, ref["summary_predict"])
    assert len(bad) == 4
    assert "2 trees" in bad[0] and "ledger after fit" in bad[1]
    assert "n_hist_launches" in bad[2] and "at 1 rows" in bad[3]


def test_compare_training_holds_forest_bags():
    """A round-forest reference's bag digests are compared on their own, so
    a card fit that differs tells the sampler apart from the histograms."""
    ref, scores = chip_smoke.training_reference(
        chip_smoke.TRAIN_TWO_HOSTS_FOREST)
    bags = list(ref["bags_sha256"])
    args = (ref, scores, [], ref["summary_fit"], ref["stats"], scores,
            ref["summary_predict"])
    assert not any("bags" in b for b in
                   chip_smoke.compare_training(*args, bags=bags))
    bad = chip_smoke.compare_training(*args, bags=bags[::-1])
    assert "member bags differ" in bad[0]
