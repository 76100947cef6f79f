"""The port's bucketize and apply_binning against the JAX package.

On a CPU tensor the port's ``bucketize`` takes the plain version; it must
be array-equal to the JAX Pallas kernel (interpret mode) and to the JAX
reference over the sweep of ``tests/test_kernels.py`` and the compare's
corners (NaN, +-inf, -0.0, values equal to a threshold, all-+inf
threshold rows).  The CUDA kernel itself is held to the same plain
version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.binning import BinnedData as JaxBinnedData
from repro.core.binning import apply_binning as jax_apply_binning
from repro.kernels.binning import bucketize as jax_bucketize
from repro.kernels.binning import bucketize_ref as jax_bucketize_ref
from repro.kernels.binning import fit_quantile_thresholds

from repro_torch.core.binning import BinnedData, apply_binning
from repro_torch.kernels.binning import bucketize, bucketize_ref
from repro_torch.kernels.binning.binning import bucketize_cuda

torch.set_num_threads(1)


def _values(n_i, n_f, n_b, dist):
    rng = np.random.default_rng(n_i + n_b)
    if dist == "normal":
        return rng.normal(0, 1, (n_i, n_f)).astype(np.float32)
    if dist == "uniform":
        return rng.uniform(-5, 5, (n_i, n_f)).astype(np.float32)
    v = rng.normal(0, 1, (n_i, n_f)).astype(np.float32)
    v[rng.random((n_i, n_f)) < 0.7] = 0.0
    return v


def _jax_both(v, thr):
    pallas = np.asarray(jax_bucketize(v, thr, use_pallas=True,
                                      interpret=True))
    ref = np.asarray(jax_bucketize_ref(jnp.asarray(v), jnp.asarray(thr)))
    np.testing.assert_array_equal(pallas, ref)
    return ref


@pytest.mark.parametrize("n_i,n_f,n_b", [(100, 4, 8), (1000, 33, 32),
                                         (513, 7, 16), (2, 1, 4)])
@pytest.mark.parametrize("dist", ["normal", "uniform", "sparse"])
def test_bucketize_matches_jax(n_i, n_f, n_b, dist):
    v = _values(n_i, n_f, n_b, dist)
    thr = fit_quantile_thresholds(v, n_b)
    want = _jax_both(v, thr)
    out = bucketize(torch.from_numpy(v), torch.from_numpy(thr))
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(
        bucketize_ref(torch.from_numpy(v), torch.from_numpy(thr)).numpy(),
        want)
    assert out.min() >= 0 and out.max() <= n_b - 1


def _edge_case():
    n_t = 7
    thr = np.stack([np.linspace(-3, 3, n_t, dtype=np.float32),
                    np.full(n_t, np.inf, np.float32),
                    np.array([-np.inf, -1.0, -0.0, 0.0, 1.0, np.inf,
                              np.inf], np.float32),
                    np.array([0.0, 0.5, 0.5, 2.0, np.inf, np.inf, np.inf],
                             np.float32),
                    np.array([-1e-45, 1e-45, 1e-38, 2e-38, np.inf, np.inf,
                              np.inf], np.float32)])
    fin = thr[np.isfinite(thr)]
    vals = np.concatenate([
        np.array([np.nan, np.inf, -np.inf, -0.0, 0.0,
                  np.finfo(np.float32).max, -np.finfo(np.float32).max,
                  np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny],
                 np.float32),
        fin, np.nextafter(fin, np.float32(np.inf)),
        np.nextafter(fin, np.float32(-np.inf))]).astype(np.float32)
    return np.repeat(vals[:, None], thr.shape[0], axis=1), thr


def test_bucketize_edge_values_match_jax():
    v, thr = _edge_case()
    want = _jax_both(v, thr)
    out = bucketize(torch.from_numpy(v), torch.from_numpy(thr)).numpy()
    np.testing.assert_array_equal(out, want)
    # the corners, spelled out: NaN counts nothing, +inf every threshold
    # (the +inf padding included), -0.0 equals 0.0, and subnormals compare
    # as zero, as XLA compares them
    assert (out[0] == 0).all()
    assert (out[1] == thr.shape[1]).all()
    np.testing.assert_array_equal(out[3], out[4])
    assert (out[:, 1][2:] == 0).all()       # all-+inf row: only +inf >= it
    tiny = (np.abs(v) < np.finfo(np.float32).tiny) & (v != 0)
    assert tiny.any()
    for i in np.flatnonzero(tiny[:, 0]):
        np.testing.assert_array_equal(out[i], out[4])


def test_bucketize_empty_and_wrong_device():
    thr = torch.zeros((3, 4))
    out = bucketize(torch.zeros((0, 3)), thr)
    assert out.shape == (0, 3) and out.dtype == torch.int32
    with pytest.raises(ValueError, match="cuda or cpu"):
        bucketize(torch.zeros((2, 3), device="meta"),
                  torch.zeros((3, 4), device="meta"))
    with pytest.raises(ValueError, match="thresholds on"):
        bucketize(torch.zeros((2, 3)), torch.zeros((3, 4), device="meta"))
    # the kernel wrapper takes CUDA tensors only: a CPU tensor never
    # reaches a build or a launch
    with pytest.raises(ValueError, match="CUDA"):
        bucketize_cuda(torch.zeros((2, 3)), thr)


@pytest.mark.parametrize("dist", ["normal", "sparse"])
def test_apply_binning_matches_jax(dist):
    fit = _values(400, 6, 16, dist)
    thr = fit_quantile_thresholds(fit, 16)
    Xn = _values(123, 6, 3, dist)
    want = jax_apply_binning(
        Xn, JaxBinnedData(bins=np.zeros((0, 6), np.int32), thresholds=thr,
                          n_bins=16), use_pallas=True)
    binned = BinnedData(bins=torch.zeros((0, 6), dtype=torch.int32),
                        thresholds=thr, n_bins=16)
    out = apply_binning(Xn, binned, device="cpu")
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), want)
    # thresholds upload once per device and are reused
    assert binned.device_thresholds(torch.device("cpu")) is \
        binned.device_thresholds(torch.device("cpu"))
    # float64 rows round to float32 as the JAX path rounds them
    X64 = np.random.default_rng(1).normal(0, 1, (64, 6))
    np.testing.assert_array_equal(
        apply_binning(X64, binned, device="cpu").numpy(),
        jax_apply_binning(X64, JaxBinnedData(
            bins=np.zeros((0, 6), np.int32), thresholds=thr, n_bins=16)))
