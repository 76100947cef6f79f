"""The port's limb substrate against the JAX package's, on the CPU.

Every operation (carry and borrow propagation, add, sub, the schoolbook
multiply, shifts, masks, padding, and the Barrett pieces) must give the
same int32 limbs as ``repro.core.he.limbs`` and the same python ints.
Inputs come from seeded numpy draws: the cases of ``tests/test_limbs.py``
(canonical big ints) plus lazy, mixed-sign limb vectors of the kind
histogram subtraction leaves behind.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.he import limbs as jl

from repro_torch.core.he import limbs as tl

torch.set_num_threads(1)


def _bigints(rng, n, bits=200):
    return [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(n)]


def _both(fn_t, fn_j, *arrays):
    """fn over torch tensors and fn over jnp arrays, as numpy."""
    got = fn_t(*[torch.from_numpy(np.asarray(a, np.int32)) for a in arrays])
    want = fn_j(*[jnp.asarray(a, jnp.int32) for a in arrays])
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", range(4))
def test_roundtrip_matches_jax(seed):
    rng = np.random.default_rng(seed)
    xs = _bigints(rng, 8) + [0, 1, (1 << 256) - 1]
    a = tl.from_pyints(xs, 32)
    np.testing.assert_array_equal(a, jl.from_pyints(xs, 32))
    assert tl.to_pyints(a) == xs
    assert tl.to_pyints(torch.from_numpy(a)) == xs
    with pytest.raises(ValueError, match="unsigned"):
        tl.from_pyints([-1], 4)
    with pytest.raises(ValueError, match="does not fit"):
        tl.from_pyints([1 << 40], 4)


@pytest.mark.parametrize("seed", range(4))
def test_add_sub_match_jax(seed):
    rng = np.random.default_rng(10 + seed)
    xs, ys = _bigints(rng, 6), _bigints(rng, 6)
    a, b = tl.from_pyints(xs, 32), tl.from_pyints(ys, 32)
    got, want = _both(tl.add, jl.add, a, b)
    np.testing.assert_array_equal(got, want)
    assert tl.to_pyints(got) == [x + y for x, y in zip(xs, ys)]
    hi = tl.from_pyints([max(x, y) for x, y in zip(xs, ys)], 32)
    lo = tl.from_pyints([min(x, y) for x, y in zip(xs, ys)], 32)
    got, want = _both(tl.sub, jl.sub, hi, lo)
    np.testing.assert_array_equal(got, want)
    assert tl.to_pyints(got) == [abs(x - y) for x, y in zip(xs, ys)]


def _lazy_mixed(rng, n_vec=16, k=40, L=24):
    """A canonical parent sum, minus an un-carried child sum, plus another
    un-carried sum: mixed-sign limbs whose values are >= 0, as lazy
    subtraction and lazy accumulation leave them."""
    cts = rng.integers(0, 256, (n_vec, k, L))
    take = rng.random((n_vec, k)) < rng.random((n_vec, 1))
    extra = rng.integers(0, 256, (n_vec, 4, L)).sum(axis=1)
    ints = [tl.to_pyints(cts[i]) for i in range(n_vec)]
    parent = tl.from_pyints([sum(v) for v in ints], L + 2).astype(np.int64)
    child = (cts * take[..., None]).sum(axis=1)
    lazy = parent - np.pad(child, ((0, 0), (0, 2))) \
        + np.pad(extra, ((0, 0), (0, 2)))
    extra_ints = [sum(int(x) << (8 * j) for j, x in enumerate(row))
                  for row in extra]
    want = [sum(x for x, t in zip(v, take[i]) if not t) + extra_ints[i]
            for i, v in enumerate(ints)]
    return lazy.astype(np.int32), want


@pytest.mark.parametrize("seed", range(6))
def test_carry_fix_mixed_sign_matches_jax(seed):
    rng = np.random.default_rng(20 + seed)
    lazy, want = _lazy_mixed(rng)
    assert (lazy < 0).any() and (lazy > 255).any()
    before = tl.carry_fix.iterations
    got, ref = _both(tl.carry_fix, jl.carry_fix, lazy)
    np.testing.assert_array_equal(got, ref)
    assert ((got >= 0) & (got <= 255)).all()
    assert tl.to_pyints(got) == want
    assert tl.carry_fix.iterations > before


def test_carry_fix_of_lazy_sums_and_overflow_match_jax():
    rng = np.random.default_rng(3)
    lazy = rng.integers(0, 255 * 70000, (5, 11)).astype(np.int32)
    got, want = _both(tl.carry_fix, jl.carry_fix, lazy)
    np.testing.assert_array_equal(got, want)
    # overflow past the last limb is dropped, arithmetic mod 256**L
    top = np.full((2, 3), 255, np.int32)
    top[:, 0] = 256
    got, want = _both(tl.carry_fix, jl.carry_fix, top)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()
    canon = rng.integers(0, 256, (4, 7)).astype(np.int32)
    before = tl.carry_fix.iterations
    np.testing.assert_array_equal(
        tl.carry_fix(torch.from_numpy(canon)).numpy(), canon)
    assert tl.carry_fix.iterations == before


@pytest.mark.parametrize("seed", range(3))
def test_borrow_fix_matches_jax(seed):
    rng = np.random.default_rng(30 + seed)
    xs = _bigints(rng, 6, 160)
    ys = [x // (2 + i) for i, x in enumerate(xs)]
    diff = tl.from_pyints(xs, 20) - tl.from_pyints(ys, 20)
    assert (diff < 0).any()
    got, want = _both(tl.borrow_fix, jl.borrow_fix, diff)
    np.testing.assert_array_equal(got, want)
    assert tl.to_pyints(got) == [x - y for x, y in zip(xs, ys)]


@pytest.mark.parametrize("k", [0, 1, 7, 8, 13, 64, 138, 300])
def test_shift_left_and_mask_match_jax(k):
    rng = np.random.default_rng(k)
    xs = _bigints(rng, 5)
    a = tl.from_pyints(xs, 32)
    for out_L in (41, None):
        got, want = _both(lambda t: tl.shift_left_bits(t, k, out_L),
                          lambda j: jl.shift_left_bits(j, k, out_L), a)
        np.testing.assert_array_equal(got, want)
    got = tl.shift_left_bits(torch.from_numpy(a), k, 41).numpy()
    assert tl.to_pyints(got) == [(x << k) % (1 << 328) for x in xs]
    got, want = _both(lambda t: tl.mask_bits(t, k),
                      lambda j: jl.mask_bits(j, k), a)
    np.testing.assert_array_equal(got, want)
    assert tl.to_pyints(got) == [x & ((1 << k) - 1) for x in xs]


@pytest.mark.parametrize("k", [0, 1, 7, 8, 13, 64, 138, 300])
def test_shift_right_bits_matches_jax(k):
    """``tests/test_limbs.py::test_shifts_and_mask``'s right shift."""
    rng = np.random.default_rng(60 + k)
    xs = _bigints(rng, 5) + [0, (1 << 256) - 1]
    a = tl.from_pyints(xs, 32)
    got, want = _both(lambda t: tl.shift_right_bits(t, k),
                      lambda j: jl.shift_right_bits(j, k), a)
    np.testing.assert_array_equal(got, want)
    assert tl.to_pyints(got) == [x >> k for x in xs]


@pytest.mark.parametrize("seed", range(4))
def test_mul_matches_jax_and_python_ints(seed):
    """``tests/test_limbs.py::test_mul``: 26-limb operands, the schoolbook
    product against the JAX package's fp32 convolve and python ints; a
    broadcast batch and unequal widths too."""
    rng = np.random.default_rng(70 + seed)
    xs = _bigints(rng, 4) + [0, (1 << 200) - 1]
    ys = _bigints(rng, 4) + [(1 << 200) - 1, (1 << 200) - 1]
    a, b = tl.from_pyints(xs, 26), tl.from_pyints(ys, 26)
    got, want = _both(tl.mul, jl.mul, a, b)
    assert got.shape == (6, 52)
    np.testing.assert_array_equal(got, want)
    assert tl.to_pyints(got) == [x * y for x, y in zip(xs, ys)]
    c = tl.from_pyints(_bigints(rng, 1, 96), 12)
    got, want = _both(tl.mul, jl.mul, c, a)
    np.testing.assert_array_equal(got, want)
    assert tl.to_pyints(got) == [tl.to_pyints(c)[0] * x for x in xs]


def test_pad_limbs_matches_jax():
    a = np.arange(12, dtype=np.int32).reshape(2, 2, 3)
    for w in (1, 3, 7):
        got, want = _both(lambda t: tl.pad_limbs(t, w),
                          lambda j: jl.pad_limbs(j, w), a)
        np.testing.assert_array_equal(got, want)
    assert tl.num_limbs_for_bits(1024) == jl.num_limbs_for_bits(1024) == 128
    assert (tl.RADIX_BITS, tl.LIMB_MASK) == (jl.RADIX_BITS, jl.LIMB_MASK)


# --------------------------------------------------------------------------
# compares, Toeplitz products and Barrett reduction (the affine cipher)
# --------------------------------------------------------------------------

def _compare_cases(rng, L=20):
    """Pairs that are equal, differ only in the lowest or the highest
    limb, or are random, with the python ints' answers."""
    xs = _bigints(rng, 6, 8 * L)
    ys = list(xs[:2]) + [xs[2] + 1, xs[3] + (1 << (8 * L - 8))] \
        + _bigints(rng, 2, 8 * L)
    xs = [x % (1 << (8 * L)) for x in xs]
    ys = [y % (1 << (8 * L)) for y in ys]
    return (tl.from_pyints(xs, L), tl.from_pyints(ys, L),
            [(x > y) - (x < y) for x, y in zip(xs, ys)])


@pytest.mark.parametrize("seed", range(3))
def test_compare_geq_is_zero_match_jax(seed):
    a, b, want = _compare_cases(np.random.default_rng(40 + seed))
    for fn_t, fn_j in ((tl.compare, jl.compare), (tl.geq, jl.geq)):
        got, ref = _both(fn_t, fn_j, a, b)
        np.testing.assert_array_equal(got, ref)
        got, ref = _both(fn_t, fn_j, b, a)
        np.testing.assert_array_equal(got, ref)
    got = tl.compare(torch.from_numpy(a), torch.from_numpy(b))
    assert got.tolist() == want
    a[0] = 0
    got, ref = _both(tl.is_zero, jl.is_zero, a)
    np.testing.assert_array_equal(got, ref)
    assert got.tolist() == [True] + [False] * 5


@pytest.mark.parametrize("seed", range(3))
def test_cond_sub_matches_jax(seed):
    rng = np.random.default_rng(50 + seed)
    n_int = _bigints(rng, 1, 160)[0] | (1 << 159)
    vals = [x % (2 * n_int) for x in _bigints(rng, 8, 168)]
    vals += [0, n_int - 1, n_int, 2 * n_int - 1]
    a = tl.from_pyints(vals, 22)
    n = tl.from_pyints([n_int], 22)[0]
    got = tl.cond_sub(torch.from_numpy(a), torch.from_numpy(n))
    want = jl.cond_sub(jnp.asarray(a), jnp.asarray(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tl.to_pyints(got) == [v % n_int for v in vals]


@pytest.mark.parametrize("k", [0, 1, 5, 31, 40])
def test_shift_right_limbs_and_toeplitz_match_jax(k):
    rng = np.random.default_rng(k)
    a = tl.from_pyints(_bigints(rng, 4, 256), 32)
    got, want = _both(lambda t: tl.shift_right_limbs(t, k),
                      lambda j: jl.shift_right_limbs(j, k), a)
    np.testing.assert_array_equal(got, want)
    b = rng.integers(0, 256, k + 1).astype(np.int32)
    np.testing.assert_array_equal(tl.toeplitz(b, 7), jl.toeplitz(b, 7))


def _barrett_case(bits, seed):
    rng = np.random.default_rng(seed)
    n_int = _bigints(rng, 1, bits)[0] | (1 << (bits - 1)) | 1
    Ln = tl.num_limbs_for_bits(bits)
    xs = _bigints(rng, 30, 16 * Ln)
    xs += [0, n_int - 1, n_int, 3 * n_int + 5, (1 << (16 * Ln)) - 1]
    return n_int, Ln, xs


@pytest.mark.parametrize("bits,seed", [(64, 0), (160, 1), (256, 2),
                                       (1024, 3)])
def test_barrett_matches_jax_and_python_ints(bits, seed):
    n_int, Ln, xs = _barrett_case(bits, seed)
    tctx = tl.barrett_precompute(n_int)
    jctx = jl.barrett_precompute(n_int)
    assert tctx.Ln == jctx.Ln == Ln
    for name in ("n", "T_mu", "T_n"):
        np.testing.assert_array_equal(getattr(tctx, name).host,
                                      np.asarray(getattr(jctx, name)))
    x = tl.from_pyints(xs, 2 * Ln)
    got = tl.barrett_reduce(torch.from_numpy(x), tctx)
    want = jl.barrett_reduce(jnp.asarray(x), jctx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tl.to_pyints(got) == [v % n_int for v in xs]
    # narrower operands are padded to 2 Ln; wider ones are refused
    got = tl.barrett_reduce(torch.from_numpy(x[:, : Ln + 3]), tctx)
    want = jl.barrett_reduce(jnp.asarray(x[:, : Ln + 3]), jctx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="too wide"):
        tl.barrett_reduce(torch.zeros((1, 2 * Ln + 1), dtype=torch.int32),
                          tctx)
    # mod_mul_fixed: (a * b) mod n for a, b < n
    b_int = xs[0] % n_int
    T_b = tl.toeplitz(tl.from_pyints([b_int], Ln)[0], Ln)
    a_ints = [v % n_int for v in xs[1:]]
    a = tl.from_pyints(a_ints, Ln)
    got = tl.mod_mul_fixed(torch.from_numpy(a), torch.from_numpy(T_b), tctx)
    want = jl.mod_mul_fixed(jnp.asarray(a), jnp.asarray(T_b), jctx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tl.to_pyints(got) == [(v * b_int) % n_int for v in a_ints]
    got = tl.mul_fixed(torch.from_numpy(a), torch.from_numpy(T_b))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jl.mul_fixed(jnp.asarray(a),
                                             jnp.asarray(T_b))))


def test_no_function_changes_its_arguments():
    """Every limb function returns new tensors and leaves its inputs as
    they were (the JAX functions are pure)."""
    n_int, Ln, xs = _barrett_case(160, 7)
    ctx = tl.barrett_precompute(n_int)
    x = torch.from_numpy(tl.from_pyints(xs, 2 * Ln))
    a = torch.from_numpy(tl.from_pyints([v % n_int for v in xs], Ln))
    b = torch.flip(a, dims=[0]).contiguous()
    n = torch.from_numpy(tl.from_pyints([n_int], Ln)[0])
    T = torch.from_numpy(tl.toeplitz(tl.from_pyints([xs[0] % n_int],
                                                    Ln)[0], Ln))
    lazy = torch.from_numpy(_lazy_mixed(np.random.default_rng(1))[0])
    diff = a - torch.minimum(a, b)
    calls = [
        (tl.carry_fix, (lazy,)), (tl.borrow_fix, (diff,)),
        (tl.add, (a, b)), (tl.sub, (torch.maximum(a, b), b)),
        (tl.compare, (a, b)), (tl.geq, (a, b)), (tl.is_zero, (a,)),
        (tl.cond_sub, (a + a, n)), (lambda t: tl.shift_right_limbs(t, 3),
                                    (a,)),
        (lambda t: tl.shift_left_bits(t, 13), (a,)),
        (lambda t: tl.shift_right_bits(t, 13), (a,)), (tl.mul, (a, b)),
        (lambda t: tl.mask_bits(t, 29), (a,)),
        (lambda t: tl.pad_limbs(t, Ln + 2), (a,)),
        (tl.mul_fixed, (a, T)), (lambda t: tl.barrett_reduce(t, ctx), (x,)),
        (lambda t, u: tl.mod_mul_fixed(t, u, ctx), (a, T)),
    ]
    for fn, args in calls:
        before = [t.clone() for t in args]
        fn(*args)
        for t, t0 in zip(args, before):
            assert torch.equal(t, t0), fn
    for name in ("n", "T_mu", "T_n"):
        table = getattr(ctx, name)
        assert torch.equal(table.on("cpu"), torch.from_numpy(table.host))
        assert table.on("cpu") is table.on(torch.device("cpu"))
