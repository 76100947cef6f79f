"""Float64 sums in a fixed order, whatever numpy version runs them.

The grower's node totals (``G_tot``, ``H_tot`` and the leaf weights' sums)
are float64 sums over a node's rows; float addition is not associative,
so their bits depend on the order of the adds.  ``ndarray.sum`` adds in
an order numpy does not promise: numpy 2.0 adds pairwise over blocks of
128 elements with eight accumulators, inside chunks of the reduction
iterator's 8192-element buffer, and numpy 2.3 gives other bits for the
same rows.  The JAX package calls ``ndarray.sum``, so its trees depend on
the numpy it runs on; the port's :func:`pairwise_sum` performs exactly
numpy 2.0's order with explicit elementwise adds, so the port grows the
same trees on any numpy and equals the JAX package wherever that runs
numpy 2.0.
"""

from __future__ import annotations

import functools

import numpy as np

PW_BLOCK = 128          # numpy's PW_BLOCKSIZE: largest pairwise leaf
CHUNK = 8192            # numpy 2.0's reduction buffer (NPY_BUFSIZE)


@functools.lru_cache(maxsize=None)
def _plan(n: int) -> tuple:
    """The pairwise order numpy uses on an n-element chunk: the leaves as
    (start, length) and the combine tree, in which an int is a leaf's
    index and a pair (left, right) is one add."""
    leaves = []

    def split(start, m):
        if m <= PW_BLOCK:
            leaves.append((start, m))
            return len(leaves) - 1
        m2 = m // 2
        m2 -= m2 % 8                      # halves stay multiples of 8
        return (split(start, m2), split(start + m2, m - m2))

    tree = split(0, n)
    return tuple(leaves), tree


def _leaf_sums(a: np.ndarray, starts: list, length: int) -> list:
    """Sums of the leaves of one length, as numpy sums a leaf: below 8
    elements one running sum; else eight running sums over the multiple of
    8 (element i into accumulator i % 8), combined as ((r0+r1)+(r2+r3))+
    ((r4+r5)+(r6+r7)), then the rest added one by one."""
    blk = a[np.asarray(starts)[:, None] + np.arange(length)]   # (k, length)
    if length < 8:
        res = np.full(len(starts), -0.0)
        for t in range(length):
            res = res + blk[:, t]
        return res.tolist()
    m = length - length % 8
    r = blk[:, :8]
    for t in range(8, m, 8):
        r = r + blk[:, t:t + 8]
    res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + \
        ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
    for t in range(m, length):
        res = res + blk[:, t]
    return res.tolist()


def pairwise_sum(x) -> np.float64:
    """``x.sum()`` of a 1-D float64 array, in numpy 2.0's order: starting
    from 0.0, one pairwise sum per chunk of 8192 elements, the chunks
    added in turn."""
    a = np.ascontiguousarray(x, dtype=np.float64)
    if a.ndim != 1:
        raise NotImplementedError(
            "pairwise_sum takes 1-D arrays (vector-valued g/h come with the "
            "MO objective, ROADMAP Queue 1 M9)")
    n = a.shape[0]
    chunks = [(s, min(CHUNK, n - s)) for s in range(0, n, CHUNK)]
    # every leaf of every chunk, grouped by length for one vector pass each
    by_len: dict = {}
    for c, (s, m) in enumerate(chunks):
        for j, (start, length) in enumerate(_plan(m)[0]):
            by_len.setdefault(length, []).append((c, j, s + start))
    sums: dict = {}
    for length, items in by_len.items():
        vals = _leaf_sums(a, [st for _, _, st in items], length)
        for (c, j, _), v in zip(items, vals):
            sums[c, j] = v

    def combine(c, node):
        if isinstance(node, int):
            return sums[c, node]
        return combine(c, node[0]) + combine(c, node[1])

    total = 0.0
    for c, (_, m) in enumerate(chunks):
        total += combine(c, _plan(m)[1])
    return np.float64(total)
