#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases, each fatal on failure (nothing is caught and carried on):

1. Card check: exits 1 when ``torch.cuda.is_available()`` is false; prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. Build: compiles every ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, one ``nvcc`` per source, all started together, and prints
   the seconds and what ptxas reported.
3. Bucketize kernel: against its plain PyTorch version on the card,
   ``torch.equal``, at the serving path's shapes (the fixture's own
   thresholds, 31 per feature) and on an edge batch (NaN, +-inf, -0.0,
   subnormals, values equal to a threshold, all-+inf threshold rows); a
   threshold table over the kernel's 48 KB of shared memory must raise.
   Prints the kernel's, the plain version's and ``torch.searchsorted``'s
   (a yardstick the port never calls) CUDA-event times per call (many
   back-to-back calls over their count, median of 5) beside the kernel's
   bound.
4. Layer histogram kernel: against its plain version, ``torch.equal``, at
   the training path's shapes (65,536 rows, 14 host features, 32 bins,
   131 limbs, 1/2/4/8 nodes) and on edge inputs (masked bins and slots,
   row counts off the tiles, 1 and non-power-of-two node counts, W = 1,
   a node count that tiles the node axis, the largest sum); a bin count
   past the kernel's shared memory must raise.  Times beside its bound,
   its plain version and one ``index_add_`` over the composite index (a
   yardstick the port never calls).
5. Fixed-constant multiply kernel (K2): against its plain version,
   ``torch.equal``, at the affine path's shapes (encryption, the two
   Barrett products and decryption at 1024- and 512-bit keys, 65,536 rows)
   and on edge inputs (all-255 x and b, zeros, 1 and 65,537 rows, an
   output narrower than the product); a row tile past the kernel's shared
   memory must raise, and ``modmul_fixed`` on the card must equal python
   ints' ``(v * b) % n``.  Times beside its bound, its plain version and
   an fp32 ``torch.matmul`` of the same shapes with TF32 off (the product
   alone, no carry; a yardstick the port never calls).
6. Forest histogram kernel (K4, the same CUDA body as K1 with a member
   axis): against its plain version, ``torch.equal``, at the forest4
   path's shapes (65,536 rows, 14 host features, 32 bins, 4 members, 67
   limbs of a 512-bit key, 1/2/4 nodes a member, a fifth of each member's
   rows in no node) and on edge inputs (all slots masked, all bins
   masked, a member with no rows, row counts off the tiles, W = 131 over
   two limb tiles, a node-tiled case, one row); at k = 1 it must equal K1.
   Times beside its bound, its plain version and one ``index_add_`` over
   the member-expanded composite index (a yardstick the port never calls).
7. Node histogram kernel (K5, the same CUDA body as K1 with one node and
   no slot vector): against its plain version, ``torch.equal``, at the
   per-node engine's shapes (the root and the left child of phase 8) and
   on edge inputs (all rows masked, bins past ``n_bins``, one row, row
   counts off the 256-row chunk, one feature, W = 33, 130 and 515, 1 and
   256 bins); a bin count past its shared memory must raise.  Times
   beside its bound, its plain version and one ``index_add_`` over the
   pre-expanded (feature, bin) index (a yardstick the port never calls).
8. Per-node engine (its path): ``CipherHistogram.node_histogram`` at the
   scale shape (65,536 rows of ``synthetic_tabular(65536, 16, seed=0)``,
   the host's 14 features binned on the card at 32 bins, the affine
   cipher of ``train_scale_affine``, 65,536 random 40-bit plaintexts):
   the root and the left child (feature 0's bin < 16) by K5 and the right
   child by ``subtract`` must equal the layer engine's (K1) histograms
   and counts; the right child's cells decrypt to the plaintext sums;
   K5's launch count, zeroed just before, must be at least 2.  Prints the
   engine's wall ms per call and each stage's (counts, gather and pad,
   K5, reduce).
9. Serving phase (the serving path): loads the committed JAX export
   ``src/repro_torch/fixtures/serving_t25_d6`` with ``load_ensemble`` on
   the card and serves it with ``FederatedPredictor``: the 65536-row
   reference batch, whose scores must equal the JAX package's committed
   scores bit for bit, four more 65536-row batches and one 1,048,576-row
   batch.  Kernel launch counts are zeroed just before and read just
   after; every kernel of the path must have launched.
10. Branches: the two small committed JAX exports under
    ``fixtures/serving_branches`` (multiclass with two hosts, and
    multi-output leaves) served on the card, scores bit-identical to the
    JAX package's, so every branch of the score accumulation is held.
11. Training phase (the training path): ``VerticalBoosting`` with the
    plain cipher trains the scale shape of ``benchmarks/bench_tree_build.py``
    (65,536 rows, 2 guest and 14 host features, 3 trees of depth 4, 32
    bins) on the card and scores the training rows; launch counts are
    zeroed just before and read just after, and both kernels must have
    launched.  Tree signatures, scores, ``channel.summary()`` after the
    fit and after scoring, and the integer ``Stats`` counters must equal
    the JAX package's committed reference
    (``fixtures/train_scale_plain``); the trained model is also served
    through a fresh ``FederatedPredictor`` against the same scores.  Then
    seconds per tree (the first apart, as warm-up), the device's idle
    share (device busy time under ``torch.profiler`` over the untraced wall
    time of the same boosting rounds, run just before; this phase profiles
    the first round only), ``carry_fix``
    and ``borrow_fix`` iterations (one sync each), and device time by stage
    (bins, K1, the layer reduce, the cumsum, compress, decrypt and decode;
    each run of the port's own kernels in the profile is added to the
    stages its launch was made in).
12. Two hosts: the small two-host case of ``tests/test_gbdt.py`` trained
    on the card, equal to its committed reference
    (``fixtures/train_two_hosts_plain``).
13. Affine training: phase 11 again with ``cipher="affine"`` (1024-bit
    key, ``fixtures/train_scale_affine``), where all three kernels must
    have launched, with the modmul stages beside the others
    (encrypt-modmul, Barrett-in-reduce, decrypt-modmul); then phase 12 with
    the affine two-host case (``fixtures/train_two_hosts_affine``:
    ``key_bits=256``, ``precision=20``).
14. Forest training: phase 11 with ``forest_size=4`` (the ``forest4`` row
    of ``benchmarks/bench_tree_build.py`` without pipelining:
    ``fixtures/train_forest4_affine``, 2 rounds of 4 member trees, 512-bit
    key), where K4 must launch 8 times (2 rounds x 4 layers) and K1 gives
    way to it in the stages; each round's member bags are held to the
    reference's sha256 as well; then the two-host forest
    (``fixtures/train_two_hosts_forest``: plain cipher, 3 members a round).
    This phase and phase 11 profile one round, phase 13 all of its rounds.
15. Serving throughput, latency and profile (after the counted runs):
    windows of back-to-back batches (100 of 65536 rows, 8 of 1,048,576),
    rows/s as all rows over the window's time, p50/p90 per batch; then a
    window of batches of each size untraced and again under
    ``torch.profiler``, for device time by kernel and the device's idle
    share of the untraced wall time.
16. Prints the seconds each phase took, the kernels' JSON line, the card
    line, and last the device line.

With ``--json PATH`` every number, the build log and the per-kernel
profiles are also written to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "src", "repro_torch", "fixtures")
FIXTURE = os.path.join(FIXTURES, "serving_t25_d6")
BRANCHES = ("serving_branches/multiclass_2hosts", "serving_branches/mo")
TRAIN_SCALE = "train_scale_plain"
TRAIN_TWO_HOSTS = "train_two_hosts_plain"
TRAIN_SCALE_AFFINE = "train_scale_affine"
TRAIN_TWO_HOSTS_AFFINE = "train_two_hosts_affine"
TRAIN_FOREST4 = "train_forest4_affine"
TRAIN_TWO_HOSTS_FOREST = "train_two_hosts_forest"

# H100 SXM published peaks: HBM3 bandwidth, and fp32 outside the tensor
# cores (the rate a compare or a 32-bit add runs at)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# and the tensor cores' dense bf16 rate
BF16_TC_OPS_PER_S = 989e12

N_BIG = 1048576


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, trials: int = 5) -> float:
    """Time of one call: CUDA events around ``reps`` back-to-back calls
    after warm-up, over the count; the median of ``trials`` such runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return float(np.median(ts))


def bucketize_bound(n_i: int, n_f: int, n_t: int) -> tuple:
    """Least time for bucketize: every value read once and every bin
    written once (4 + 4 bytes per element, plus the table), or n_t fp32
    compares per element — whichever is longer."""
    t_bytes = (8 * n_i * n_f + 4 * n_f * n_t) / HBM_BYTES_PER_S
    t_ops = n_i * n_f * n_t / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def serving_batch(ref, n: int) -> np.ndarray:
    """The fixture's batch generator, ``n`` rows; the first ``ref["n"]``
    are the reference batch."""
    rng = np.random.default_rng(int(ref["seed"]))
    return rng.normal(float(ref["loc"]), float(ref["scale"]),
                      (n, int(ref["d"]))).astype(np.float32)


def split(ref, X) -> tuple:
    """The guest's columns and the list of each host's columns."""
    b = ref["bounds"]
    parts = [X[:, lo:hi] for lo, hi in zip(b[:-1], b[1:])]
    return parts[0], parts[1:]


def edge_batch(torch, dev, thr_np: np.ndarray) -> tuple:
    """Values and thresholds that probe the compare's corners."""
    n_t = thr_np.shape[1]
    thr = np.stack([np.linspace(-3, 3, n_t, dtype=np.float32),
                    np.full(n_t, np.inf, np.float32),
                    np.concatenate([[-np.inf, -1.0, -0.0, 0.0, 1.0],
                                    np.full(n_t - 5, np.inf)]
                                   ).astype(np.float32),
                    np.concatenate([[-1e-45, 1e-45, 1e-38, 2e-38],
                                    np.full(n_t - 4, np.inf)]
                                   ).astype(np.float32),
                    thr_np[0]])
    fin = thr[np.isfinite(thr)]
    vals = np.concatenate([
        np.array([np.nan, np.inf, -np.inf, -0.0, 0.0,
                  np.finfo(np.float32).max, -np.finfo(np.float32).max],
                 np.float32),
        fin, np.nextafter(fin, np.float32(np.inf)),
        np.nextafter(fin, np.float32(-np.inf))]).astype(np.float32)
    vals = np.repeat(vals[:, None], thr.shape[0], axis=1)
    return (torch.as_tensor(vals, device=dev),
            torch.as_tensor(thr, device=dev))


def kernel_phase(torch, dev, thr_g, thr_h, X):
    from repro_torch.kernels.binning import bucketize, bucketize_ref
    thr_all = torch.cat([thr_g, thr_h])
    cases = [("guest", 65536, thr_g, slice(0, 2)),
             ("host", 65536, thr_h, slice(2, 16)),
             ("guest", N_BIG, thr_g, slice(0, 2)),
             ("host", N_BIG, thr_h, slice(2, 16)),
             ("all", N_BIG, thr_all, slice(0, 16))]
    rows = []
    for party, n, thr, cols in cases:
        v = torch.as_tensor(X[:n, cols], device=dev).contiguous()
        out = bucketize(v, thr)
        ref = bucketize_ref(v, thr)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"bucketize kernel != plain at {party} {tuple(v.shape)}: "
                 f"{int((out != ref).sum())} elements differ")
        err = int((out.long() - ref.long()).abs().max())
        vt = v.T.contiguous()
        ms = time_ms(torch, lambda: bucketize(v, thr))
        plain_ms = time_ms(torch, lambda: bucketize_ref(v, thr), reps=5)
        lib_ms = time_ms(torch, lambda: torch.searchsorted(thr, vt,
                                                           right=True))
        bound_ms, bound_by = bucketize_bound(n, v.shape[1], thr.shape[1])
        rows.append(dict(party=party, shape=[n, v.shape[1], thr.shape[1]],
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"kernel bucketize {party} {n}x{v.shape[1]}x{thr.shape[1]}: "
              f"equal, ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib_ms:.5f} bound_ms={bound_ms:.5f} "
              f"({bound_by})", flush=True)
    v, thr = edge_batch(torch, dev, thr_g.cpu().numpy())
    out, ref = bucketize(v, thr), bucketize_ref(v, thr)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        bad = (out != ref).nonzero()[:8].tolist()
        fail(f"bucketize kernel != plain on the edge batch at {bad}")
    print(f"kernel bucketize edge batch {tuple(v.shape)}: equal", flush=True)
    big = torch.full((v.shape[1], 4096), float("inf"), device=dev)
    try:
        bucketize(v, big)
    except ValueError:
        print("kernel bucketize refuses a 64 KB+ threshold table", flush=True)
    else:
        fail("bucketize took a threshold table over its shared memory")
    return rows


def serving_phase(torch, dev, ref, X):
    from repro_torch.kernels.binning import bucketize
    from repro_torch.serving import FederatedPredictor, load_ensemble
    ens = load_ensemble(FIXTURE, device=dev)
    pred = FederatedPredictor(ens.guest, ens.hosts, device=dev)
    n_g = int(ref["n_guest"])
    n_ref = int(ref["n"])
    spans = [(i * n_ref, (i + 1) * n_ref) for i in range(5)] + [(0, N_BIG)]

    bucketize.launches = 0
    scores, times = [], []
    for lo, hi in spans:
        t0 = time.perf_counter()
        s = pred.predict_score(X[lo:hi, :n_g], [X[lo:hi, n_g:]])
        times.append(time.perf_counter() - t0)   # scores are on the host
        scores.append(s)
    launches = {"bucketize": bucketize.launches}

    if not np.array_equal(scores[0], ref["scores"]):
        d = np.flatnonzero(scores[0] != ref["scores"])
        fail(f"served scores differ from the JAX reference at {d.size} rows"
             f", first {d[:4].tolist()}")
    for (lo, hi), s in zip(spans, scores):
        if s.shape != (hi - lo,) or not np.isfinite(s).all():
            fail(f"batch {lo}:{hi}: scores of shape {s.shape}, finite="
                 f"{bool(np.isfinite(s).all())}")
    for (lo, hi), s in zip(spans[:5], scores[:5]):
        if not np.array_equal(scores[-1][lo:hi], s):
            fail(f"rows {lo}:{hi} score differently in the 1M batch")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the serving path never launched the {name} kernel")

    summ = pred.channel.summary()
    res = dict(
        batches=[hi - lo for lo, hi in spans],
        batch_ms=[t * 1e3 for t in times],
        predict_req=summ["predict_req"], predict_bits=summ["predict_bits"],
        n_predict_roundtrips=pred.stats.n_predict_roundtrips,
        n_predict_batches=pred.stats.n_predict_batches,
        launches=launches, bit_identical_to_jax=True,
        n_trees=ens.guest.n_trees, n_nodes=ens.guest.n_nodes,
        k_parties=ens.guest.k_parties.tolist())
    print(f"serving: scores bit-identical to the JAX reference on "
          f"{n_ref} rows; batch ms (the first cold) "
          + ", ".join(f"{t * 1e3:.3f}" for t in times) + "; "
          f"predict_req={summ['predict_req']} "
          f"predict_bits={summ['predict_bits']} "
          f"n_predict_roundtrips={pred.stats.n_predict_roundtrips} "
          f"bucketize.launches={launches['bucketize']}", flush=True)
    return pred, res


def branch_phase(torch, dev) -> list:
    """Serve each small committed export on the card; its scores must
    equal the JAX package's bit for bit."""
    from repro_torch.serving import FederatedPredictor, load_ensemble
    rows = []
    for name in BRANCHES:
        path = os.path.join(FIXTURES, name)
        ref = np.load(os.path.join(path, "reference.npz"))
        ens = load_ensemble(path, device=dev)
        pred = FederatedPredictor(ens.guest, ens.hosts, device=dev)
        Xg, Xh = split(ref, serving_batch(ref, int(ref["n"])))
        got = pred.predict_score(Xg, Xh)
        if got.shape != ref["scores"].shape or not np.array_equal(
                got, ref["scores"]):
            fail(f"{name}: served scores differ from the JAX reference")
        rows.append(dict(name=name, objective=ens.guest.objective,
                         hosts=len(ens.hosts), trees=ens.guest.n_trees,
                         rows=int(ref["n"]), bit_identical_to_jax=True))
        print(f"branch {name} ({ens.guest.objective}, {len(ens.hosts)} "
              f"host(s), {ens.guest.n_trees} trees): scores bit-identical "
              f"to the JAX reference on {int(ref['n'])} rows", flush=True)
    return rows


def hist_bound(bins, slot, W: int, n_nodes: int, n_bins: int) -> tuple:
    """Least time for the layer (slot (n_i,)), forest (slot (n_i, k)) or
    node (slot None: every row in the one node, no slot read) histogram on
    these inputs: every slot read, the bins and limbs of the rows that lie
    in a node of some member read once, the k histograms written once; or
    one 32-bit add per (counted row, member, feature, limb) -- whichever
    is longer."""
    n_i, n_f = bins.shape
    slot_words = 0 if slot is None else slot.numel()
    if slot is None:
        slot = bins.new_zeros(n_i)
    slot = slot.reshape(n_i, -1)
    k = slot.shape[1]
    in_node = (slot >= 0) & (slot < n_nodes)                  # (n_i, k)
    rows = int(in_node.any(dim=1).sum())
    bins_ok = ((bins >= 0) & (bins < n_bins)).sum(dim=1)      # (n_i,)
    pairs = int((bins_ok * in_node.sum(dim=1)).sum())
    nbytes = 4 * (slot_words + rows * (n_f + W)
                  + k * n_nodes * n_f * n_bins * W)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = pairs * W / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_inputs(torch, dev, n_i, n_f, n_bins, n_nodes, W, seed,
              bin_mask=0.0, slot_mask=0.0):
    """Random bins, slots and canonical limbs on the card, with the given
    shares of the bins and of the slots set to -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=g, device=dev, dtype=torch.int32)
    bins = torch.randint(0, n_bins, (n_i, n_f), **kw)
    slot = torch.randint(0, n_nodes, (n_i,), **kw)
    cts = torch.randint(0, 256, (n_i, W), **kw)
    bins[torch.rand((n_i, n_f), generator=g, device=dev) < bin_mask] = -1
    slot[torch.rand((n_i,), generator=g, device=dev) < slot_mask] = -1
    return bins, slot, cts


# layer histogram edge inputs: name, n_i, n_f, n_bins, n_nodes, W, mask
K1_EDGES = [
    ("masked bins and slots", 65536, 14, 32, 4, 131, 0.3),
    ("rows off the tile", 65537, 14, 32, 3, 131, 0.1),
    ("few rows, 5 nodes", 1000, 5, 32, 5, 131, 0.1),
    ("one row", 1, 1, 2, 1, 1, 0.0),
    ("W = 1", 4099, 7, 32, 4, 1, 0.2),
    ("node-tiled: 64 nodes x 256 bins", 4096, 3, 256, 64, 131, 0.1),
]


def layer_hist_phase(torch, dev) -> list:
    """K1 against its plain version at the training path's shapes and on
    edge inputs, ``torch.equal``; timed at the path's shapes."""
    from repro_torch.kernels.histogram import layer_hist_ref
    from repro_torch.kernels.histogram.histogram import layer_hist_cuda
    n_i, n_f, n_bins, W = 65536, 14, 32, 131
    rows = []
    for n_nodes in (1, 2, 4, 8):
        # layer 0 has every row in its one node; deeper layers send only
        # the rows of their direct nodes, about half, to the kernel
        mask = 0.0 if n_nodes == 1 else 0.5
        bins, slot, cts = k1_inputs(torch, dev, n_i, n_f, n_bins, n_nodes,
                                    W, seed=n_nodes, slot_mask=mask)
        out = layer_hist_cuda(bins, slot, cts, n_nodes, n_bins)
        ref = layer_hist_ref(bins, slot, cts, n_nodes, n_bins)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"layer_hist kernel != plain at {n_nodes} nodes: "
                 f"{int((out != ref).sum())} sums differ")
        err = int((out.long() - ref.long()).abs().max())
        # the yardstick: one index_add_ over the composite index, its
        # source expanded to one limb row per (row, feature) beforehand
        ok = (slot[:, None] >= 0) & (bins >= 0)
        idx = ((slot.long()[:, None] * n_f
                + torch.arange(n_f, device=dev)) * n_bins + bins.long())[ok]
        src = cts.unsqueeze(1).expand(n_i, n_f, W)[ok].contiguous()
        lib_out = torch.zeros((n_nodes * n_f * n_bins, W), dtype=torch.int32,
                              device=dev)
        lib_out.index_add_(0, idx, src)
        if not torch.equal(lib_out.view_as(ref), ref):
            fail(f"the index_add_ yardstick disagrees at {n_nodes} nodes")
        ms = time_ms(torch, lambda: layer_hist_cuda(bins, slot, cts,
                                                    n_nodes, n_bins))
        plain_ms = time_ms(torch, lambda: layer_hist_ref(bins, slot, cts,
                                                         n_nodes, n_bins),
                           reps=5)
        lib_ms = time_ms(torch, lambda: lib_out.index_add_(0, idx, src))
        bound_ms, bound_by = hist_bound(bins, slot, W, n_nodes, n_bins)
        del idx, src, lib_out
        rows.append(dict(shape=[n_i, n_f, n_bins, W], n_nodes=n_nodes,
                         masked_slots=mask, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"kernel layer_hist {n_i}x{n_f}x{n_bins}x{W} {n_nodes} "
              f"node(s): equal, ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib_ms:.5f} bound_ms={bound_ms:.5f} "
              f"({bound_by})", flush=True)
    for name, n_i, n_f, n_bins, n_nodes, W, mask in K1_EDGES:
        bins, slot, cts = k1_inputs(torch, dev, n_i, n_f, n_bins, n_nodes,
                                    W, seed=n_i, bin_mask=mask,
                                    slot_mask=mask)
        out = layer_hist_cuda(bins, slot, cts, n_nodes, n_bins)
        ref = layer_hist_ref(bins, slot, cts, n_nodes, n_bins)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"layer_hist kernel != plain on edge input '{name}'")
        print(f"kernel layer_hist edge '{name}' ({n_i}x{n_f}x{n_bins}x{W}, "
              f"{n_nodes} nodes): equal", flush=True)
    # the largest sum: 2**20 rows of limbs 255 in one cell
    n_i = 1 << 20
    bins = torch.zeros((n_i, 2), dtype=torch.int32, device=dev)
    slot = torch.zeros(n_i, dtype=torch.int32, device=dev)
    cts = torch.full((n_i, W), 255, dtype=torch.int32, device=dev)
    out = layer_hist_cuda(bins, slot, cts, 1, n_bins)
    ref = layer_hist_ref(bins, slot, cts, 1, n_bins)
    torch.cuda.synchronize()
    if not torch.equal(out, ref) or int(out[0, 0, 0, 0]) != n_i * 255:
        fail("layer_hist kernel != plain on the largest sum")
    print(f"kernel layer_hist edge 'largest sum' ({n_i} rows of 255 in one "
          f"cell = {n_i * 255}): equal", flush=True)
    try:
        layer_hist_cuda(bins[:8, :1].contiguous(), slot[:8],
                        cts[:8, :1].contiguous(), 1, 20000)
    except RuntimeError:
        print("kernel layer_hist refuses 20000 bins (past its shared "
              "memory)", flush=True)
    else:
        fail("layer_hist took a bin count past its shared memory")
    return rows


def k4_inputs(torch, dev, n_i, n_f, n_bins, k, n_nodes, W, seed,
              bin_mask=0.0, slot_mask=0.0):
    """Random bins, (n_i, k) member slots and canonical limbs on the card,
    with the given shares of the bins and of each member's slots set to
    -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=g, device=dev, dtype=torch.int32)
    bins = torch.randint(0, n_bins, (n_i, n_f), **kw)
    slot = torch.randint(0, n_nodes, (n_i, k), **kw)
    cts = torch.randint(0, 256, (n_i, W), **kw)
    bins[torch.rand((n_i, n_f), generator=g, device=dev) < bin_mask] = -1
    slot[torch.rand((n_i, k), generator=g, device=dev) < slot_mask] = -1
    return bins, slot, cts


def k4_edges(torch, dev) -> list:
    """Forest histogram edge inputs: (name, bins, slot, cts, n_nodes,
    n_bins)."""
    out = []
    bins, slot, cts = k4_inputs(torch, dev, 65536, 14, 32, 4, 4, 67, 1)
    out.append(("all slots masked", bins, torch.full_like(slot, -1), cts,
                4, 32))
    out.append(("all bins masked", torch.full_like(bins, -1), slot, cts, 4,
                32))
    empty = slot.clone()
    empty[:, 2] = -1
    out.append(("member 2 has no rows", bins, empty, cts, 4, 32))
    for name, n_i, n_f, n_bins, k, n_nodes, W in (
            ("rows off the tile", 65537, 14, 32, 4, 3, 67),
            ("few rows, 5 nodes, k = 3", 1000, 5, 32, 3, 5, 67),
            ("W = 131, k = 3 (limb-tiled)", 8193, 14, 32, 3, 3, 131),
            ("node-tiled: 64 nodes x 256 bins, k = 2", 4096, 3, 256, 2, 64,
             67),
            ("one row", 1, 1, 2, 2, 1, 1)):
        b, sl, c = k4_inputs(torch, dev, n_i, n_f, n_bins, k, n_nodes, W,
                             seed=n_i, bin_mask=0.1, slot_mask=0.2)
        out.append((name, b, sl, c, n_nodes, n_bins))
    return out


def forest_hist_phase(torch, dev) -> list:
    """K4 against its plain version at the forest4 path's shapes (65,536
    rows, 14 host features, 32 bins, 4 members, W = 67 limbs of a 512-bit
    key, 1/2/4 nodes a member, a fifth of each member's rows in no node)
    and on edge inputs, ``torch.equal``; k = 1 against K1 too.  Timed at
    the path's shapes beside its bound, its plain version and one
    ``index_add_`` over the member-expanded composite index (a yardstick
    the port never calls)."""
    from repro_torch.kernels.histogram import forest_hist_ref
    from repro_torch.kernels.histogram.histogram import (forest_hist_cuda,
                                                         layer_hist_cuda)
    n_i, n_f, n_bins, k, W = 65536, 14, 32, 4, 67
    rows = []
    for n_nodes in (1, 2, 4):
        bins, slot, cts = k4_inputs(torch, dev, n_i, n_f, n_bins, k, n_nodes,
                                    W, seed=n_nodes, slot_mask=0.2)
        out = forest_hist_cuda(bins, slot, cts, n_nodes, n_bins)
        ref = forest_hist_ref(bins, slot, cts, n_nodes, n_bins)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"forest_hist kernel != plain at k={k}, {n_nodes} nodes: "
                 f"{int((out != ref).sum())} sums differ")
        err = int((out.long() - ref.long()).abs().max())
        # the yardstick: one index_add_ over the (member, node, feature,
        # bin) index, its source expanded to one limb row per (row,
        # member, feature) beforehand
        ok = (slot[:, :, None] >= 0) & (bins[:, None, :] >= 0)
        idx = (((torch.arange(k, device=dev)[None, :, None] * n_nodes
                 + slot.long()[:, :, None]) * n_f
                + torch.arange(n_f, device=dev)) * n_bins
               + bins.long()[:, None, :])[ok]
        src = cts[:, None, None, :].expand(n_i, k, n_f, W)[ok].contiguous()
        lib_out = torch.zeros((k * n_nodes * n_f * n_bins, W),
                              dtype=torch.int32, device=dev)
        lib_out.index_add_(0, idx, src)
        if not torch.equal(lib_out.view_as(ref), ref):
            fail(f"the index_add_ yardstick disagrees at {n_nodes} nodes")
        ms = time_ms(torch, lambda: forest_hist_cuda(bins, slot, cts,
                                                     n_nodes, n_bins))
        plain_ms = time_ms(torch, lambda: forest_hist_ref(bins, slot, cts,
                                                          n_nodes, n_bins),
                           reps=5)
        lib_ms = time_ms(torch, lambda: lib_out.index_add_(0, idx, src))
        bound_ms, bound_by = hist_bound(bins, slot, W, n_nodes, n_bins)
        del idx, src, lib_out
        rows.append(dict(shape=[n_i, n_f, n_bins, W], k=k, n_nodes=n_nodes,
                         masked_slots=0.2, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"kernel forest_hist {n_i}x{n_f}x{n_bins}x{W} k={k} {n_nodes} "
              f"node(s): equal, ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib_ms:.5f} bound_ms={bound_ms:.5f} "
              f"({bound_by})", flush=True)
    for name, bins, slot, cts, n_nodes, nb in k4_edges(torch, dev):
        out = forest_hist_cuda(bins, slot, cts, n_nodes, nb)
        ref = forest_hist_ref(bins, slot, cts, n_nodes, nb)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"forest_hist kernel != plain on edge input '{name}'")
        print(f"kernel forest_hist edge '{name}' ({tuple(bins.shape)}, k="
              f"{slot.shape[1]}, {n_nodes} nodes, W={cts.shape[1]}): equal",
              flush=True)
    # k = 1 is K1: the same sums through either entry
    bins, slot, cts = k4_inputs(torch, dev, n_i, n_f, n_bins, 1, 4, W, 7,
                                bin_mask=0.1, slot_mask=0.2)
    out = forest_hist_cuda(bins, slot, cts, 4, n_bins)
    k1 = layer_hist_cuda(bins, slot[:, 0].contiguous(), cts, 4, n_bins)
    ref = forest_hist_ref(bins, slot, cts, 4, n_bins)
    torch.cuda.synchronize()
    if not (torch.equal(out, ref) and torch.equal(out[0], k1)):
        fail("forest_hist at k = 1 != layer_hist")
    print("kernel forest_hist edge 'k = 1': equal to its plain version and "
          "to layer_hist", flush=True)
    return rows


def node_engine_inputs(torch, dev):
    """The per-node engine phase's inputs, on the card: the scale shape's
    rows (``synthetic_tabular(65536, 16, seed=0)``), the host's 14 features
    binned at 32 bins; the affine cipher of ``train_scale_affine`` (1024-bit
    key from seed 1, W = 131 limbs at histogram width); 65,536 random
    40-bit plaintexts, encrypted, (n, 1, Ln); and the nodes: the root, the
    left child (feature 0's bin < 16) and the right child."""
    import types

    from repro_torch.core.binning import bin_features
    from repro_torch.core.he import get_cipher
    from repro_torch.data import synthetic_tabular
    X, _ = synthetic_tabular(65536, 16, seed=0)
    data = bin_features(X[:, 2:], 32, device=dev)
    cipher = get_cipher("affine", key_bits=1024, seed=1)
    pts = np.random.default_rng(18).integers(0, 1 << 40, X.shape[0])
    cts = cipher.encrypt_ints([int(v) for v in pts], device=dev)
    left = data.bins[:, 0] < 16
    return types.SimpleNamespace(
        data=data, cipher=cipher, pts=pts, cts=cts.reshape(len(pts), 1, -1),
        nodes={"root": np.arange(len(pts)), "left": np.flatnonzero(left),
               "right": np.flatnonzero(~left)})


def node_rows_on_card(torch, dev, inp, rows):
    """One node's kernel operands as the engine makes them: its bins and
    its limbs padded to histogram width, flat, on the card."""
    from repro_torch.core.he import limbs
    idx = torch.as_tensor(rows, device=dev)
    bins = torch.as_tensor(inp.data.bins[rows], device=dev)
    cts = limbs.pad_limbs(inp.cts[idx], inp.cipher.hist_width)
    return bins, cts.reshape(len(rows), -1).contiguous()


def k5_inputs(torch, dev, n_i, n_f, n_bins, W, seed, lo=0, hi=None,
              bin_mask=0.0):
    """Random bins in [lo, hi) (default [0, n_bins)) and canonical limbs
    on the card, with the given share of the bins set to -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=g, device=dev, dtype=torch.int32)
    bins = torch.randint(lo, n_bins if hi is None else hi, (n_i, n_f), **kw)
    cts = torch.randint(0, 256, (n_i, W), **kw)
    bins[torch.rand((n_i, n_f), generator=g, device=dev) < bin_mask] = -1
    return bins, cts


# node histogram edge inputs: name, n_i, n_f, n_bins, W, bins' range
# (None: [0, n_bins)), masked share
K5_EDGES = [
    ("all rows masked", 65536, 14, 32, 131, None, 1.0),
    ("bins >= n_bins", 4099, 14, 32, 131, (-3, 40), 0.0),
    ("one row", 1, 14, 32, 131, None, 0.0),
    ("rows off the 256-row chunk", 65537, 14, 32, 131, None, 0.1),
    ("few rows off the chunk", 1000, 14, 32, 131, None, 0.1),
    ("n_f = 1", 4096, 1, 32, 131, None, 0.1),
    ("W = 33", 300, 17, 32, 33, None, 0.15),
    ("W = 130", 257, 9, 16, 130, None, 0.15),
    ("W = 515 (4096-bit plain key, the limb axis tiles)", 65536, 14, 32, 515,
     None, 0.1),
    ("n_bins = 1", 4096, 14, 1, 131, None, 0.1),
    ("n_bins = 256", 65536, 14, 256, 131, None, 0.1),
]


def node_hist_phase(torch, dev, inp) -> list:
    """K5 against its plain version, ``torch.equal``, at the per-node
    engine's shapes (the root and the left child of ``inp``: 14 features,
    32 bins, W = 131) and on edge inputs; timed at those shapes beside its
    bound, its plain version and one ``index_add_`` over the pre-expanded
    (feature, bin) index (a yardstick the port never calls)."""
    from repro_torch.kernels.histogram import hist_ref
    from repro_torch.kernels.histogram.histogram import hist_cuda
    n_bins = 32
    rows = []
    for node in ("root", "left"):
        bins, cts = node_rows_on_card(torch, dev, inp, inp.nodes[node])
        (n_i, n_f), W = bins.shape, cts.shape[1]
        out = hist_cuda(bins, cts, n_bins)
        ref = hist_ref(bins, cts, n_bins)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"node_hist kernel != plain at the {node} ({n_i} rows): "
                 f"{int((out != ref).sum())} sums differ")
        err = int((out.long() - ref.long()).abs().max())
        ok = (bins >= 0) & (bins < n_bins)
        idx = (torch.arange(n_f, device=dev) * n_bins + bins.long())[ok]
        src = cts.unsqueeze(1).expand(n_i, n_f, W)[ok].contiguous()
        lib_out = torch.zeros((n_f * n_bins, W), dtype=torch.int32,
                              device=dev)
        lib_out.index_add_(0, idx, src)
        if not torch.equal(lib_out.view_as(ref), ref):
            fail(f"the index_add_ yardstick disagrees at the {node}")
        ms = time_ms(torch, lambda: hist_cuda(bins, cts, n_bins))
        plain_ms = time_ms(torch, lambda: hist_ref(bins, cts, n_bins),
                           reps=5)
        lib_ms = time_ms(torch, lambda: lib_out.index_add_(0, idx, src))
        bound_ms, bound_by = hist_bound(bins, None, W, 1, n_bins)
        del idx, src, lib_out
        rows.append(dict(node=node, shape=[n_i, n_f, n_bins, W],
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"kernel node_hist {node} {n_i}x{n_f}x{n_bins}x{W}: equal, "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
              f"bound_ms={bound_ms:.5f} ({bound_by})", flush=True)
    for name, n_i, n_f, nb, W, span, mask in K5_EDGES:
        lo, hi = span if span else (0, None)
        bins, cts = k5_inputs(torch, dev, n_i, n_f, nb, W, seed=n_i + W,
                              lo=lo, hi=hi, bin_mask=mask)
        out = hist_cuda(bins, cts, nb)
        ref = hist_ref(bins, cts, nb)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"node_hist kernel != plain on edge input '{name}'")
        print(f"kernel node_hist edge '{name}' ({n_i}x{n_f}x{nb}x{W}): "
              f"equal", flush=True)
    try:
        hist_cuda(bins[:8, :1].contiguous(), cts[:8, :1].contiguous(), 20000)
    except RuntimeError:
        print("kernel node_hist refuses 20000 bins (past its shared memory)",
              flush=True)
    else:
        fail("node_hist took a bin count past its shared memory")
    return rows


def node_engine_phase(torch, dev, inp) -> dict:
    """The per-node engine at full width: ``CipherHistogram.node_histogram``
    (K5) for the root and the left child and ``subtract`` for the right
    child must equal what the layer engine (K1, through ``CipherFrontier``)
    gives for the same nodes; the right child's cells, decrypted, must
    equal the plaintext sums; K5's launch count, zeroed just before the
    counted calls, must be at least 2.  Then the engine's wall ms per
    ``node_histogram`` call and per stage of it."""
    from repro_torch.core.frontier import CipherFrontier
    from repro_torch.core.histogram import CipherHistogram
    from repro_torch.core.party import Stats
    from repro_torch.kernels.histogram import ciphertext_histogram
    data, cts, nodes = inp.data, inp.cts, inp.nodes
    engine = CipherHistogram(inp.cipher, 32, stats=Stats())
    frontier = CipherFrontier(engine, data, cts)
    k1 = frontier.layer_histograms({0: nodes["root"]}, [0], [])
    k1.update(frontier.layer_histograms(
        {1: nodes["left"], 2: nodes["right"]}, direct=[1],
        subtract=[(2, 0, 1)]))

    # the counted run: K5's count zeroed just before, read just after
    ciphertext_histogram.launches = 0
    n_stats = engine.stats.n_hist_launches
    root = engine.node_histogram(data, cts, nodes["root"])
    left = engine.node_histogram(data, cts, nodes["left"])
    right = engine.subtract(root, left)
    torch.cuda.synchronize()
    launches = ciphertext_histogram.launches
    if launches < 2 or launches != engine.stats.n_hist_launches - n_stats:
        fail(f"{launches} node_hist launches over 2 node_histogram calls "
             f"(Stats counts {engine.stats.n_hist_launches - n_stats})")
    for nid, node, (hist, cnt) in ((0, "root", root), (1, "left", left),
                                   (2, "right", right)):
        if not (torch.equal(hist, k1[nid][0])
                and np.array_equal(cnt, k1[nid][1])):
            fail(f"the per-node engine's {node} ({len(nodes[node])} rows) "
                 f"!= the layer engine's")
    # the right child's cells, decrypted, against the plaintext sums
    rows = nodes["right"]
    n_f, n_b = right[1].shape
    want = np.zeros((n_f, n_b), np.int64)
    for f in range(n_f):
        np.add.at(want[f], data.bins[rows, f], inp.pts[rows])
    got = inp.cipher.decrypt_to_ints(right[0].reshape(n_f * n_b, -1))
    if got != [int(v) for v in want.ravel()]:
        fail("the right child's decrypted cells != the plaintext sums")

    def wall_ms(fn, reps=5):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    def stages_ms(rows):
        """The call's stages, each timed alone as the engine runs it: the
        host's bin gather and counts, the limbs' gather and pad with the
        bins' copy to the card, the K5 wrapper, and the reduce."""
        from repro_torch.kernels.histogram import count_histogram
        k_bins, k_cts = node_rows_on_card(torch, dev, inp, rows)
        lazy = ciphertext_histogram(k_bins, k_cts, 32).reshape(
            k_bins.shape[1], 32, 1, -1)
        return {"counts": wall_ms(lambda: count_histogram(
                    np.asarray(data.bins, np.int32)[rows], 32)),
                "gather_pad": wall_ms(lambda: node_rows_on_card(
                    torch, dev, inp, rows)),
                "kernel": wall_ms(lambda: ciphertext_histogram(
                    k_bins, k_cts, 32)),
                "reduce": wall_ms(lambda: inp.cipher.reduce(lazy))}

    walls = {k: wall_ms(lambda: engine.node_histogram(data, cts, nodes[k]))
             for k in ("root", "left")}
    res = dict(rows={k: len(v) for k, v in nodes.items()},
               launches=launches, equal_to_layer_engine=True,
               decrypted_cells=len(got), wall_ms=walls,
               stage_ms={k: stages_ms(nodes[k]) for k in ("root", "left")})
    print(f"node engine: root ({res['rows']['root']} rows), left "
          f"({res['rows']['left']}) and right by subtraction "
          f"({res['rows']['right']}) equal the layer engine (K1); the "
          f"right child's {len(got)} cells decrypt to the plaintext sums; "
          f"node_hist launches {launches}; wall ms per node_histogram call "
          f"root {res['wall_ms']['root']:.3f}, left "
          f"{res['wall_ms']['left']:.3f}", flush=True)
    for k, st in res["stage_ms"].items():
        print(f"node engine {k} stages ms: "
              + ", ".join(f"{n} {v:.3f}" for n, v in st.items()), flush=True)
    return res


def mul_fixed_bound(N: int, T) -> tuple:
    """Least time for the fixed-constant multiply on these inputs: x read
    once, T read once, the product written once; or one multiply-add
    (two operations) per row and non-zero entry of T at the tensor cores'
    bf16 rate (limbs below 2**8 are exact in bf16 and their products'
    sums in fp32 below 2**24) -- whichever is longer."""
    Lx, Lo = T.shape
    t_bytes = 4 * (N * Lx + Lx * Lo + N * Lo) / HBM_BYTES_PER_S
    t_ops = 2 * N * int((T != 0).sum()) / BF16_TC_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k2_tables(torch, dev) -> dict:
    """The Toeplitz tables of the affine path at 1024- and 512-bit keys
    (the scale fixture's key and ``benchmarks/bench_tree_build.py``'s
    affine one), and an all-255 constant, on the card."""
    from repro_torch.core.he import get_cipher, limbs
    out = {}
    for bits in (1024, 512):
        c = get_cipher("affine", key_bits=bits, seed=1)
        out[f"encrypt {bits}"] = c.T_enc.on(dev)
        out[f"Barrett mu {bits}"] = c.bctx.T_mu.on(dev)
        out[f"Barrett n {bits}"] = c.bctx.T_n.on(dev)
        out[f"decrypt {bits}"] = c.T_dec.on(dev)
    ones = np.full(129, 255, np.int32)
    out["all-255 b"] = torch.as_tensor(limbs.toeplitz(ones, 130), device=dev)
    return out


def k2_rows(torch, dev, n: int, Lx: int, seed: int, fill=None):
    """n rows of canonical limbs on the card: random from ``seed``, or all
    ``fill``."""
    if fill is not None:
        return torch.full((n, Lx), fill, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (n, Lx), generator=g, device=dev,
                         dtype=torch.int32)


def mul_fixed_phase(torch, dev) -> list:
    """K2 against its plain version, ``torch.equal``, at the affine path's
    shapes (encrypt, Barrett and decrypt at 1024- and 512-bit keys, 65,536
    rows) and on edge inputs; timed at the path's shapes beside its bound,
    its plain version and an fp32 ``torch.matmul`` of the same shapes
    (TF32 off: the product alone, with no carry; a yardstick the port
    never calls).  Then ``modmul_fixed`` on the card against python
    ints."""
    from repro_torch.core.he import get_cipher, limbs
    from repro_torch.kernels.modmul import modmul_fixed, mul_fixed_ref
    from repro_torch.kernels.modmul.modmul import mul_fixed_cuda
    tables = k2_tables(torch, dev)
    n = 65536
    rows = []
    for name, T in tables.items():
        if name == "all-255 b":
            continue
        x = k2_rows(torch, dev, n, T.shape[0], seed=T.shape[1])
        out = mul_fixed_cuda(x, T)
        ref = mul_fixed_ref(x, T)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"mul_fixed kernel != plain at {name} {n}x{T.shape[0]}x"
                 f"{T.shape[1]}: {int((out != ref).sum())} limbs differ")
        err = int((out.long() - ref.long()).abs().max())
        xf, Tf = x.float(), T.float()
        ms = time_ms(torch, lambda: mul_fixed_cuda(x, T))
        plain_ms = time_ms(torch, lambda: mul_fixed_ref(x, T), reps=5)
        lib_ms = time_ms(torch, lambda: torch.matmul(xf, Tf))
        bound_ms, bound_by = mul_fixed_bound(n, T)
        rows.append(dict(case=name, shape=[n, T.shape[0], T.shape[1]],
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"kernel mul_fixed {name} {n}x{T.shape[0]}x{T.shape[1]}: "
              f"equal, ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib_ms:.5f} bound_ms={bound_ms:.5f} "
              f"({bound_by})", flush=True)
    T_enc, T_mu = tables["encrypt 1024"], tables["Barrett mu 1024"]
    T_255 = tables["all-255 b"]
    edges = [
        ("all-255 x and b", k2_rows(torch, dev, n, 130, 0, fill=255), T_255),
        ("all-255 x, Barrett mu", k2_rows(torch, dev, n, 130, 0, fill=255),
         T_mu),
        ("zeros", k2_rows(torch, dev, n, 128, 0, fill=0), T_enc),
        ("N = 1", k2_rows(torch, dev, 1, 128, 1), T_enc),
        ("N = 65,537", k2_rows(torch, dev, n + 1, 130, 2), T_mu),
        ("Lo < Lx + Lb (the wrap)", k2_rows(torch, dev, 4099, 130, 3),
         T_255[:, :200].contiguous()),
        ("all-255, the wrap", k2_rows(torch, dev, 4099, 130, 0, fill=255),
         T_255[:, :131].contiguous()),
    ]
    for name, x, T in edges:
        out = mul_fixed_cuda(x, T)
        ref = mul_fixed_ref(x, T)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"mul_fixed kernel != plain on edge input '{name}'")
        print(f"kernel mul_fixed edge '{name}' ({x.shape[0]}x{T.shape[0]}x"
              f"{T.shape[1]}): equal", flush=True)
    try:
        wide = torch.zeros((8, 2000), dtype=torch.int32, device=dev)
        mul_fixed_cuda(wide, torch.zeros((2000, 2000), dtype=torch.int32,
                                         device=dev))
    except RuntimeError:
        print("kernel mul_fixed refuses Lx = Lo = 2000 (past its shared "
              "memory)", flush=True)
    else:
        fail("mul_fixed took a row tile past its shared memory")
    # modmul_fixed on the card: (v * b) mod n against python ints
    c = get_cipher("affine", key_bits=1024, seed=1)
    rng = np.random.default_rng(7)
    vals = [int.from_bytes(rng.bytes(128), "little") % c.n_int
            for _ in range(300)] + [0, 1, c.n_int - 1]
    b_int = int.from_bytes(rng.bytes(128), "little") % c.n_int
    T_b = torch.as_tensor(limbs.toeplitz(limbs.from_pyints([b_int], c.Ln)[0],
                                         c.Ln), device=dev)
    got = modmul_fixed(torch.as_tensor(limbs.from_pyints(vals, c.Ln),
                                       device=dev), T_b, c.bctx)
    if limbs.to_pyints(got) != [(v * b_int) % c.n_int for v in vals]:
        fail("modmul_fixed on the card != (v * b) % n")
    print(f"modmul_fixed on the card: {len(vals)} rows equal to python "
          f"ints' (v * b) % n at 1024 bits", flush=True)
    return rows


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def training_reference(name: str) -> tuple:
    """A committed JAX training reference: (reference dict, scores)."""
    path = os.path.join(FIXTURES, name)
    with open(os.path.join(path, "reference.json")) as f:
        ref = json.load(f)
    with np.load(os.path.join(path, "scores.npz")) as z:
        scores = z["scores"]
    return ref, scores


def training_data(ref) -> tuple:
    """The reference's rows, rebuilt from its seed: guest columns, the
    list of each host's columns, labels."""
    from repro_torch.data import synthetic_tabular
    d = ref["data"]
    X, y = synthetic_tabular(d["n"], d["d"], seed=d["seed"])
    b = d["bounds"]
    parts = [X[:, lo:hi] for lo, hi in zip(b[:-1], b[1:])]
    return parts[0], parts[1:], y


def signature_json(tree) -> list:
    """``tree.signature()`` in the reference's JSON form (the float64 leaf
    weight as the hex of its bytes)."""
    return [list(row[:8]) + [None if row[8] is None else row[8].hex()]
            for row in tree.signature()]


def int_stats(stats) -> dict:
    return {k: v for k, v in stats.as_dict().items()
            if isinstance(v, int) and not isinstance(v, bool)}


def bags_digest(bags) -> str:
    """sha256 of one round's member bags (row positions), as int64: the
    reference's ``bags_sha256`` entries."""
    return hashlib.sha256(np.stack([np.asarray(b, np.int64)
                                    for b in bags]).tobytes()).hexdigest()


def compare_training(ref, ref_scores, trees, summary_fit: dict,
                     stats: dict, scores, summary_predict: dict,
                     bags=None) -> list:
    """Every way a trained model differs from its reference; [] when the
    trees, ledgers, counters, scores and (for a round-forest) each round's
    member bags are all equal."""
    bad = []
    if "bags_sha256" in ref and bags != ref["bags_sha256"]:
        bad.append(f"member bags differ from the reference's (the sampler, "
                   f"not the histograms): {bags} != {ref['bags_sha256']}")
    sigs = [signature_json(t) for t in trees]
    if len(sigs) != len(ref["signatures"]):
        bad.append(f"{len(sigs)} trees, reference {len(ref['signatures'])}")
    for t, (a, b) in enumerate(zip(sigs, ref["signatures"])):
        if a != b:
            diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
            bad.append(f"tree {t}: {len(a)} nodes (reference {len(b)}), "
                       f"first differing node {diff[:1]}")
    if summary_fit != ref["summary_fit"]:
        bad.append(f"ledger after fit {summary_fit} != {ref['summary_fit']}")
    if summary_predict != ref["summary_predict"]:
        bad.append(f"ledger after scoring {summary_predict} != "
                   f"{ref['summary_predict']}")
    diff = {k: (stats.get(k), v) for k, v in ref["stats"].items()
            if stats.get(k) != v}
    if diff:
        bad.append(f"Stats counters differ (got, reference): {diff}")
    scores = np.asarray(scores)
    if scores.shape != ref_scores.shape or not np.array_equal(scores,
                                                              ref_scores):
        n = int((scores != ref_scores).sum()) if \
            scores.shape == ref_scores.shape else -1
        bad.append(f"scores differ from the reference at {n} rows")
    return bad


def train_and_compare(name: str, device) -> tuple:
    """Train a committed reference's run with the port on ``device`` and
    score its training rows.  Returns (model, mismatches, fit seconds)."""
    from repro_torch.core import SBTParams, VerticalBoosting
    from repro_torch.core.boosting import forest_bags
    ref, ref_scores = training_reference(name)
    Xg, Xh, y = training_data(ref)
    params = SBTParams(device=device, **ref["params"])
    t0 = time.perf_counter()
    model = VerticalBoosting(params)
    model.fit(Xg, y, Xh)
    fit_s = time.perf_counter() - t0
    summary_fit = model.channel.summary()
    stats = int_stats(model.stats)
    scores = model.predict_score(Xg, Xh)
    bags = ([bags_digest(forest_bags(params, t, len(y)))
             for t in range(params.n_trees)]
            if params.forest_size > 1 else None)
    return (model, compare_training(ref, ref_scores, model.trees, summary_fit,
                                    stats, scores, model.channel.summary(),
                                    bags=bags),
            fit_s)


# the port's own kernels, launched through ctypes with no PyTorch op
# around them, which the profiler does not attribute to the enclosing
# range: (wrapper module, launching function, kernel name).  K1, K4 and K5
# are one kernel body, so their launches are matched to its runs together.
OWN_LAUNCHERS = (("repro_torch.kernels.binning.ops", "bucketize_cuda",
                  "bucketize_kernel"),
                 ("repro_torch.kernels.histogram.ops", "layer_hist_cuda",
                  "layer_hist_kernel"),
                 ("repro_torch.kernels.histogram.ops", "forest_hist_cuda",
                  "layer_hist_kernel"),
                 ("repro_torch.kernels.histogram.ops", "hist_cuda",
                  "layer_hist_kernel"),
                 ("repro_torch.kernels.modmul.ops", "mul_fixed_cuda",
                  "mul_fixed_kernel"))


@contextlib.contextmanager
def stage_ranges(torch, affine: bool = False, forest: bool = False):
    """Wrap the training path's stages in ``torch.profiler`` ranges (only
    while profiling here; the port itself carries none), the affine
    cipher's modmul stages too when ``affine``, the forest histogram's
    launch in place of the layer histogram's when ``forest``, and note
    the stages each launch of the port's own kernels was made in.  Yields a namespace:
    ``names``, the stage names (a caller that reached a stage by a name
    bound before the patch would bypass its range, so the caller fails on
    any stage the profile saw no call of), and ``own_ms(prof)``, the own
    kernels' device ms by stage in the profile ``prof``: the kernels the
    profile saw, in the order they ran, are the launches noted since the
    last call, in the order they were made (one stream runs them in
    order), and a count that differs fails the run."""
    import importlib
    import types

    import repro_torch.core.boosting as boosting
    import repro_torch.core.tree as tree
    import repro_torch.kernels.modmul as modmul
    from repro_torch.core.he.affine import AffineCipher
    from repro_torch.core.histogram import CipherHistogram
    hist = ("K4", "_forest_dispatch", "forest_hist") if forest else \
        ("K1", "_layer_dispatch", "layer_hist")
    targets = [(boosting, "bin_features", "sbt:bins"),
               (tree, "_encrypt_all", "sbt:encrypt"),
               (CipherHistogram, "layer_histograms",
                f"sbt:layer_histograms ({hist[0]} + lazy_sub + reduce)"),
               (CipherHistogram, hist[1], f"sbt:{hist[0]} {hist[2]}"),
               (CipherHistogram, "cumsum", "sbt:cumsum + reduce"),
               (tree.compress_mod, "compress_batch", "sbt:compress"),
               (tree, "_host_layer_finish", "sbt:decrypt + decode"),
               (tree, "_guest_layer_candidates", "sbt:guest histograms")]
    if affine:
        targets += [(modmul, "encrypt_batch", "sbt:encrypt-modmul"),
                    (AffineCipher, "reduce",
                     "sbt:Barrett-in-reduce (carry_fix + Barrett)"),
                    (modmul, "decrypt_batch", "sbt:decrypt-modmul")]
    stack, launched, saved = [], [], []

    def ranged(fn, label):
        @functools.wraps(fn)
        def inner(*a, **k):
            stack.append(label[4:])
            try:
                with torch.profiler.record_function(label):
                    return fn(*a, **k)
            finally:
                stack.pop()
        return inner

    def noted(fn, kernel):
        @functools.wraps(fn)
        def inner(*a, **k):
            out = fn(*a, **k)
            launched.append((kernel, tuple(stack)))
            return out
        return inner

    def own_ms(prof) -> dict:
        out = {}
        for kernel in dict.fromkeys(k for _, _, k in OWN_LAUNCHERS):
            mine = [st for k, st in launched if k == kernel]
            seen = sorted((e for e in prof.events() if kernel in e.name
                           and "CUDA" in str(e.device_type)),
                          key=lambda e: e.time_range.start)
            if len(seen) != len(mine):
                fail(f"the profile saw {len(seen)} {kernel} runs, the "
                     f"wrapper made {len(mine)} launches")
            for stages, e in zip(mine, seen):
                for st in stages:
                    out[st] = out.get(st, 0.0) + e.time_range.elapsed_us() \
                        / 1e3
        launched.clear()
        return out

    for obj, attr, label in targets:
        fn = getattr(obj, attr)
        saved.append((obj, attr, fn))
        setattr(obj, attr, ranged(fn, label))
    for mod, attr, kernel in OWN_LAUNCHERS:
        obj = importlib.import_module(mod)
        fn = getattr(obj, attr)
        saved.append((obj, attr, fn))
        setattr(obj, attr, noted(fn, kernel))
    try:
        yield types.SimpleNamespace(
            names=[label[4:] for _, _, label in targets], own_ms=own_ms)
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def device_work(prof) -> list:
    """Every kernel, copy and memset the profile saw on the card, by name,
    largest first (the ranges' mirrors on the device timeline left out)."""
    rows = []
    for e in prof.key_averages():
        if (not e.key.startswith("sbt:")
                and "cuda" in str(getattr(e, "device_type", "")).lower()):
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0)
            rows.append(dict(name=e.key, calls=e.count,
                             device_ms=dev_us / 1e3))
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def stage_times(prof, own_ms: dict) -> dict:
    """Host and device ms of each ``sbt:`` range in the profile: the host
    time of the range, and the device time of the work launched inside it
    (the range's host event with its children, not the span of its mirror
    on the device timeline), plus the port's own kernels launched in it
    (``own_ms``, by stage)."""
    stages = {}
    for e in prof.events():
        if e.name.startswith("sbt:") and "CPU" in str(e.device_type):
            st = stages.setdefault(e.name[4:], dict(calls=0, device_ms=0.0,
                                                    cpu_ms=0.0))
            st["calls"] += 1
            st["device_ms"] += getattr(e, "device_time_total", 0) / 1e3
            st["cpu_ms"] += e.cpu_time_total / 1e3
    for name, ms in own_ms.items():
        if name in stages:
            stages[name]["device_ms"] += ms
    return stages


def training_phase(torch, dev, name: str, rounds: int | None = None) -> dict:
    """The training path on the card for the committed reference ``name``
    (plain or affine cipher, one tree or a round-forest a round), counted,
    then timed and profiled over its first ``rounds`` boosting rounds (all
    of them when None)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import SBTParams, VerticalBoosting
    from repro_torch.core.he import limbs
    from repro_torch.kernels.binning import bucketize
    from repro_torch.serving import FederatedPredictor, PackedEnsemble

    ref, ref_scores = training_reference(name)
    Xg, Xh, y = training_data(ref)
    affine = ref["params"]["cipher"] == "affine"
    k = ref["params"].get("forest_size", 1)
    hist_name, hist = hist_counter(k)
    counters = {"bucketize": bucketize, hist_name: hist}
    if affine:
        from repro_torch.kernels.modmul import mul_fixed
        counters["mul_fixed"] = mul_fixed

    # the counted run: fit and score, launch counts zeroed just before
    for c in counters.values():
        c.launches = 0
    carry0 = limbs.carry_fix.iterations
    borrow0 = limbs.borrow_fix.iterations
    model, bad, fit_s = train_and_compare(name, dev)
    launches = {k: c.launches for k, c in counters.items()}
    carry_iters = limbs.carry_fix.iterations - carry0
    borrow_iters = limbs.borrow_fix.iterations - borrow0
    if bad:
        fail(f"{name} differs from the JAX reference: " + "; ".join(bad))
    for kname, count in launches.items():
        if count <= 0:
            fail(f"the {name} training path never launched the {kname} "
                 f"kernel")
    if launches[hist_name] != model.stats.n_hist_launches:
        fail(f"{launches[hist_name]} {hist_name} launches, Stats counts "
             f"{model.stats.n_hist_launches}")
    tree_s = list(model.stats.tree_seconds)     # one entry a round

    # the trained model, served through a fresh FederatedPredictor
    ens = PackedEnsemble.from_model(model, device=dev)
    served = FederatedPredictor(ens.guest, ens.hosts,
                                device=dev).predict_score(Xg, Xh)
    if not np.array_equal(served, ref_scores):
        fail(f"the {name} model served through FederatedPredictor differs "
             f"from the reference scores")
    print(f"training {name}: trees, scores ({len(ref_scores)} rows), "
          f"ledgers and Stats counters equal to the JAX reference; served "
          f"again through FederatedPredictor, equal; fit {fit_s:.3f} s; "
          f"seconds per round of {k} tree(s) "
          + ", ".join(f"{t:.3f}" for t in tree_s)
          + f" (the first is warm-up); launches {launches}; carry_fix "
          f"iterations {carry_iters}, borrow_fix iterations {borrow_iters}",
          flush=True)

    # untraced wall of the boosting rounds, then the same rounds traced
    params = SBTParams(device=dev, **ref["params"])
    n_rounds = params.n_trees if rounds is None else rounds
    m2 = VerticalBoosting(params)
    score = m2.begin_fit(Xg, y, Xh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n_rounds):
        score = m2.boost_round(t, score)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    m3 = VerticalBoosting(params)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with stage_ranges(torch, affine, forest=k > 1) as ranges:
        with profile(activities=acts) as prof_bins:
            score = m3.begin_fit(Xg, y, Xh)
            torch.cuda.synchronize()
        own_bins = ranges.own_ms(prof_bins)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for t in range(n_rounds):
                score = m3.boost_round(t, score)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        own_rounds = ranges.own_ms(prof)
    if [signature_json(t) for t in m3.trees] != \
            ref["signatures"][:n_rounds * k]:
        fail(f"the traced {name} run grew other trees")
    kernels = device_work(prof)
    busy = sum(r["device_ms"] for r in kernels)
    if busy <= 0:
        fail("the profiler saw no device time in the boosting rounds")
    stages = stage_times(prof, own_rounds)
    binning = stage_times(prof_bins, own_bins).get("bins")
    quiet = [k for k in ranges.names
             if not (binning if k == "bins" else stages.get(k))]
    if quiet:
        fail(f"the profile saw no call of the stages {quiet}: their ranges "
             f"were bypassed")
    res = dict(
        fixture=name, params=ref["params"], data=ref["data"],
        equal_to_jax=True, fit_s=fit_s, trees_per_round=k,
        round_seconds=tree_s, warmup_round_s=tree_s[0],
        steady_round_s=(float(np.mean(tree_s[1:])) if len(tree_s) > 1
                        else None),
        member_tree_seconds=[t / k for t in tree_s],
        launches=launches, carry_fix_iterations=carry_iters,
        borrow_fix_iterations=borrow_iters,
        n_hist_launches=model.stats.n_hist_launches,
        n_split_roundtrips=model.stats.n_split_roundtrips,
        profiled_rounds=n_rounds, rounds_wall_ms=wall_ms,
        rounds_traced_ms=traced_ms,
        rounds_device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
        rounds_device_launches=sum(r["calls"] for r in kernels),
        traced_idle_share=1.0 - busy / traced_ms,
        per_round_stage_device_ms={st: v["device_ms"] / n_rounds
                                   for st, v in stages.items()},
        per_round_stage_host_ms={st: v["cpu_ms"] / n_rounds
                                 for st, v in stages.items()},
        stages=stages, binning=binning, kernels=kernels[:25])
    print(f"training profile {name}: {n_rounds} rounds in {wall_ms:.3f} ms "
          f"untraced ({traced_ms:.3f} traced), device busy {busy:.3f} ms, "
          f"idle share {res['idle_share']:.3f}; per round by stage, device "
          f"ms / host ms: " + "; ".join(f"{st}={v['device_ms'] / n_rounds:.3f}/"
                                        f"{v['cpu_ms'] / n_rounds:.3f}"
                                        for st, v in sorted(stages.items()))
          + f"; binning (once per fit) device ms / host ms "
          f"{binning['device_ms']:.3f}/{binning['cpu_ms']:.3f}"
          + "; top kernels: " + "; ".join(
              f"{r['name'][:40]}={r['device_ms']:.3f}x{r['calls']}"
              for r in kernels[:6]), flush=True)
    return res


def hist_counter(k: int) -> tuple:
    """(name, wrapper) of the histogram kernel a fit with ``forest_size``
    k launches: K4 for a round-forest, K1 otherwise."""
    from repro_torch.kernels.histogram import (forest_ciphertext_histogram,
                                               layer_ciphertext_histogram)
    return (("forest_hist", forest_ciphertext_histogram) if k > 1
            else ("layer_hist", layer_ciphertext_histogram))


def two_host_phase(dev, name: str) -> dict:
    ref, _ = training_reference(name)
    hist_name, hist = hist_counter(ref["params"].get("forest_size", 1))
    hist.launches = 0
    model, bad, fit_s = train_and_compare(name, dev)
    if bad:
        fail(f"{name} differs from the JAX reference: " + "; ".join(bad))
    if not 0 < hist.launches == model.stats.n_hist_launches:
        fail(f"{hist.launches} {hist_name} launches, Stats counts "
             f"{model.stats.n_hist_launches}")
    print(f"training {name}: trees, scores, ledgers and Stats counters "
          f"equal to the JAX reference ({len(model.host_data)} hosts, "
          f"{len(model.trees)} trees, {hist.launches} {hist_name} launches, "
          f"fit {fit_s:.3f} s)", flush=True)
    return dict(fixture=name, hosts=len(model.host_data), equal_to_jax=True,
                fit_s=fit_s, launches={hist_name: hist.launches})


def serve_window(pred, X, n_g: int, n_rows: int, n_batches: int) -> list:
    """``n_batches`` back-to-back batches of ``n_rows`` rows (numpy in,
    numpy scores out), cycling over the rows of X; the host-clock time of
    each batch in ms."""
    ts = []
    for i in range(n_batches):
        lo = (i * n_rows) % X.shape[0]
        t0 = time.perf_counter()
        pred.predict_score(X[lo:lo + n_rows, :n_g], [X[lo:lo + n_rows, n_g:]])
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def latency_phase(pred, X, n_g: int, n_rows: int, n_batches: int) -> dict:
    """Closed loop, one caller: rows/s over the whole window (stalls
    included), p50 and p90 per batch.  Not part of the counted run."""
    ts = np.asarray(serve_window(pred, X, n_g, n_rows, n_batches))
    res = dict(rows=n_rows, samples=n_batches,
               window_ms=float(ts.sum()),
               rows_per_s=n_rows * n_batches / (float(ts.sum()) / 1e3),
               p50_ms=float(np.percentile(ts, 50)),
               p90_ms=float(np.percentile(ts, 90)))
    print(f"latency: {n_batches} batches of {n_rows} rows in "
          f"{res['window_ms']:.3f} ms, {res['rows_per_s']:.0f} rows/s; "
          f"p50 {res['p50_ms']:.3f} ms, p90 {res['p90_ms']:.3f} ms",
          flush=True)
    return res


def profile_phase(torch, pred, X, n_g: int, n_rows: int,
                  n_batches: int) -> dict:
    """Device time by kernel over a window of ``n_batches`` batches (not
    counted), and the device's idle share: one minus device busy time
    over the wall time of the same window run untraced just before (the
    profiler's own host cost inflates the traced wall time, which is
    reported beside it)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_window(pred, X, n_g, n_rows, n_batches)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_window(pred, X, n_g, n_rows, n_batches)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        kernels.append(dict(name=e.key, calls=e.count,
                            device_ms=dev_us / 1e3))
    kernels.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in kernels)
    res = dict(rows=n_rows, batches=n_batches, wall_ms=wall_ms,
               traced_wall_ms=traced_ms, device_busy_ms=busy,
               idle_share=1.0 - busy / wall_ms,
               traced_idle_share=1.0 - busy / traced_ms,
               launches_per_batch=sum(r["calls"] for r in kernels)
               / n_batches, kernels=kernels)
    print(f"profile ({n_batches} batches of {n_rows} rows): wall "
          f"{wall_ms:.3f} ms untraced ({traced_ms:.3f} traced), device busy "
          f"{busy:.3f} ms, idle share {res['idle_share']:.3f} "
          f"({res['traced_idle_share']:.3f} of the traced wall), "
          f"{res['launches_per_batch']:.0f} kernels and copies per batch; "
          "top: " + "; ".join(f"{r['name'][:40]}={r['device_ms']:.3f}x"
                              f"{r['calls']}" for r in kernels[:6]),
          flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write every number and the profile here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.serving import load_guest, load_host

    card = card_line()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # seconds each phase takes, for the run's time budget
    clock = [time.perf_counter()]
    phase_s = {}

    def lap(phase: str):
        now = time.perf_counter()
        phase_s[phase] = now - clock[0]
        clock[0] = now

    # one nvcc per source, all started together
    names = build.sources()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        build_logs = dict(zip(names, pool.map(build.build, names)))
    print(f"build: {', '.join(n + '.cu' for n in names)} in parallel in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    lap("build")

    ref = np.load(os.path.join(FIXTURE, "reference.npz"))
    X = serving_batch(ref, N_BIG)
    if not np.array_equal(X[:int(ref["n"])],
                          serving_batch(ref, int(ref["n"]))):
        fail("the 1M batch does not extend the reference batch")
    thr_g = load_guest(os.path.join(FIXTURE, "guest"), dev).thresholds
    thr_h = load_host(os.path.join(FIXTURE, "host0"), dev).thresholds

    krows = kernel_phase(torch, dev, thr_g, thr_h, X)
    lap("bucketize")
    hrows = layer_hist_phase(torch, dev)
    lap("layer_hist")
    mrows = mul_fixed_phase(torch, dev)
    lap("mul_fixed")
    frows = forest_hist_phase(torch, dev)
    lap("forest_hist")
    node_inp = node_engine_inputs(torch, dev)
    nrows = node_hist_phase(torch, dev, node_inp)
    lap("node_hist")
    node_engine = node_engine_phase(torch, dev, node_inp)
    del node_inp
    lap("node_engine")
    pred, serving = serving_phase(torch, dev, ref, X)
    branches = branch_phase(torch, dev)
    lap("serving")
    # the plain scale run profiles one round: its reference check covers
    # the whole fit, and the affine phase profiles all of its rounds
    training = training_phase(torch, dev, TRAIN_SCALE, rounds=1)
    two_hosts = two_host_phase(dev, TRAIN_TWO_HOSTS)
    lap("training_plain")
    training_affine = training_phase(torch, dev, TRAIN_SCALE_AFFINE)
    two_hosts_affine = two_host_phase(dev, TRAIN_TWO_HOSTS_AFFINE)
    lap("training_affine")
    # the forest4 run profiles one round of its two
    training_forest = training_phase(torch, dev, TRAIN_FOREST4, rounds=1)
    if training_forest["launches"]["forest_hist"] != 8:
        fail(f"{training_forest['launches']['forest_hist']} forest_hist "
             f"launches in {TRAIN_FOREST4}, not 8 (2 rounds x 4 layers)")
    two_hosts_forest = two_host_phase(dev, TRAIN_TWO_HOSTS_FOREST)
    lap("training_forest")
    n_g = int(ref["n_guest"])
    latency = [latency_phase(pred, X, n_g, int(ref["n"]), 100),
               latency_phase(pred, X, n_g, N_BIG, 8)]
    prof = [profile_phase(torch, pred, X, n_g, int(ref["n"]), 10),
            profile_phase(torch, pred, X, n_g, N_BIG, 2)]
    lap("serving_latency_profile")
    print("phase seconds: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in phase_s.items()),
          flush=True)

    main_row = next(r for r in krows
                    if r["party"] == "host" and r["shape"][0] == N_BIG)
    k1_row = hrows[0]                       # layer 0: 65536 rows, 1 node
    k2_row = mrows[0]                       # encryption, 1024-bit key
    k4_row = frows[-1]                      # the largest call: 4 nodes
    k5_row = nrows[0]                       # the root: 65536 rows
    kernels = {"kernels": [
        dict(name="bucketize", route="cuda",
             source="src/repro_torch/csrc/bucketize.cu",
             replaces="src/repro/kernels/binning/binning.py:42",
             launches=serving["launches"]["bucketize"],
             launches_by_path={
                 "serving": serving["launches"]["bucketize"],
                 "training": training["launches"]["bucketize"],
                 "training_affine": training_affine["launches"]["bucketize"],
                 "training_forest": training_forest["launches"]["bucketize"]},
             max_abs_err=max(r["max_abs_err"] for r in krows),
             ms=main_row["ms"], plain_ms=main_row["plain_ms"],
             bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
             library_ms=main_row["library_ms"], shape=main_row["shape"],
             matches_plain=True),
        dict(name="layer_hist", route="cuda",
             source="src/repro_torch/csrc/layer_hist.cu",
             replaces="src/repro/kernels/histogram/histogram.py:142",
             launches=training["launches"]["layer_hist"],
             launches_by_path={
                 "training": training["launches"]["layer_hist"],
                 "training_affine":
                     training_affine["launches"]["layer_hist"]},
             max_abs_err=max(r["max_abs_err"] for r in hrows),
             ms=k1_row["ms"], plain_ms=k1_row["plain_ms"],
             bound_ms=k1_row["bound_ms"], bound_by=k1_row["bound_by"],
             library_ms=k1_row["library_ms"], shape=k1_row["shape"],
             n_nodes=k1_row["n_nodes"], matches_plain=True),
        dict(name="mul_fixed", route="cuda",
             source="src/repro_torch/csrc/mul_fixed.cu",
             replaces="src/repro/kernels/modmul/modmul.py:67",
             launches=training_affine["launches"]["mul_fixed"],
             max_abs_err=max(r["max_abs_err"] for r in mrows),
             ms=k2_row["ms"], plain_ms=k2_row["plain_ms"],
             bound_ms=k2_row["bound_ms"], bound_by=k2_row["bound_by"],
             library_ms=k2_row["library_ms"], shape=k2_row["shape"],
             case=k2_row["case"], matches_plain=True),
        dict(name="forest_hist", route="cuda",
             source="src/repro_torch/csrc/layer_hist.cu",
             replaces="src/repro/kernels/histogram/histogram.py:217",
             launches=training_forest["launches"]["forest_hist"],
             launches_by_path={
                 "training_forest": training_forest["launches"]["forest_hist"],
                 "two_hosts_forest": two_hosts_forest["launches"][
                     "forest_hist"]},
             max_abs_err=max(r["max_abs_err"] for r in frows),
             ms=k4_row["ms"], plain_ms=k4_row["plain_ms"],
             bound_ms=k4_row["bound_ms"], bound_by=k4_row["bound_by"],
             library_ms=k4_row["library_ms"], shape=k4_row["shape"],
             k=k4_row["k"], n_nodes=k4_row["n_nodes"], matches_plain=True),
        dict(name="node_hist", route="cuda",
             source="src/repro_torch/csrc/layer_hist.cu",
             replaces="src/repro/kernels/histogram/histogram.py:74",
             launches=node_engine["launches"],
             max_abs_err=max(r["max_abs_err"] for r in nrows),
             ms=k5_row["ms"], plain_ms=k5_row["plain_ms"],
             bound_ms=k5_row["bound_ms"], bound_by=k5_row["bound_by"],
             library_ms=k5_row["library_ms"], shape=k5_row["shape"],
             matches_plain=True)]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_logs=build_logs,
                           kernel_rows=krows, layer_hist_rows=hrows,
                           mul_fixed_rows=mrows, forest_hist_rows=frows,
                           node_hist_rows=nrows, node_engine=node_engine,
                           serving=serving,
                           branches=branches, training=training,
                           two_hosts=two_hosts,
                           training_affine=training_affine,
                           two_hosts_affine=two_hosts_affine,
                           training_forest=training_forest,
                           two_hosts_forest=two_hosts_forest,
                           latency=latency, profile=prof,
                           phase_seconds=phase_s,
                           **kernels, device=device), f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
