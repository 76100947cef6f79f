"""The port's pinned float64 sum (``core/sums.py``).

``pairwise_sum`` must add in numpy 2.0's order: the same bits as
``ndarray.sum`` under numpy 2.0 (what the JAX package's grower calls), and
the same bits as a direct recursive statement of that order, which holds
under any numpy.
"""

import numpy as np
import pytest

from repro_torch.core.sums import CHUNK, PW_BLOCK, pairwise_sum


def _numpy20_sum(a):
    """numpy 2.0's float64 reduction, written out: 0.0, then one pairwise
    sum per 8192-element chunk (leaves of at most 128 with eight
    accumulators, halves cut to multiples of 8)."""
    def pw(x):
        n = len(x)
        if n < 8:
            res = -0.0
            for v in x:
                res += float(v)
            return res
        if n <= PW_BLOCK:
            m = n - n % 8
            r = [float(x[j]) for j in range(8)]
            for i in range(8, m, 8):
                for j in range(8):
                    r[j] += float(x[i + j])
            res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5])
                                                     + (r[6] + r[7]))
            for v in x[m:]:
                res += float(v)
            return res
        n2 = n // 2
        n2 -= n2 % 8
        return pw(x[:n2]) + pw(x[n2:])

    total = 0.0
    for s in range(0, len(a), CHUNK):
        total += pw(a[s:s + CHUNK])
    return total


SIZES = [0, 1, 5, 7, 8, 9, 127, 128, 129, 255, 1000, 4097, 8191, 8192,
         8193, 16385, 21473, 65536, 70001]


@pytest.mark.parametrize("n", SIZES)
def test_pairwise_sum_is_numpy20_order(n):
    rng = np.random.default_rng(n)
    for a in (rng.normal(0, 1, n), rng.uniform(-1, 1, n) * 1e-3,
              np.maximum(rng.uniform(0, 0.25, n), 1e-16)):
        got = pairwise_sum(a)
        assert isinstance(got, np.float64)
        assert got == _numpy20_sum(a) == a.sum()


def test_pairwise_sum_refuses_vectors_and_takes_views():
    with pytest.raises(NotImplementedError, match="M9"):
        pairwise_sum(np.zeros((4, 2)))
    a = np.random.default_rng(0).normal(0, 1, 3000)
    assert pairwise_sum(a[::3]) == a[::3].copy().sum()
