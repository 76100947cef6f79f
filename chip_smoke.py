#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases, each fatal on failure (nothing is caught and carried on):

1. Card check: exits 1 when ``torch.cuda.is_available()`` is false; prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. Build: compiles every ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` and prints the seconds and what ptxas reported.
3. Kernel phase: the bucketize kernel against its plain PyTorch version on
   the card, ``torch.equal``, at the serving path's shapes (the fixture's
   own thresholds, 31 per feature) and on an edge batch (NaN, +-inf, -0.0,
   subnormals, values equal to a threshold, all-+inf threshold rows); a
   threshold table over the kernel's 48 KB of shared memory must raise.
   Prints the kernel's, the plain version's and ``torch.searchsorted``'s
   (a yardstick the port never calls) CUDA-event times per call (many
   back-to-back calls over their count, median of 5) beside the kernel's
   bound.
4. Serving phase (the port's main path): loads the committed JAX export
   ``src/repro_torch/fixtures/serving_t25_d6`` with ``load_ensemble`` on
   the card and serves it with ``FederatedPredictor``: the 65536-row
   reference batch, whose scores must equal the JAX package's committed
   scores bit for bit, four more 65536-row batches and one 1,048,576-row
   batch.  Kernel launch counts are zeroed just before and read just
   after; every kernel of the path must have launched.
5. Branches: the two small committed JAX exports under
   ``fixtures/serving_branches`` (multiclass with two hosts, and
   multi-output leaves) served on the card, scores bit-identical to the
   JAX package's, so every branch of the score accumulation is held.
6. Throughput, latency and profile (after the counted run): windows of
   back-to-back batches (100 of 65536 rows, 8 of 1,048,576), rows/s as
   all rows over the window's time, p50/p90 per batch; then a window of
   batches of each size untraced and again under ``torch.profiler``, for
   device time by kernel and the device's idle share of the untraced
   wall time.
7. Prints the kernels' JSON line, the card line, and last the device line.

With ``--json PATH`` every number, the build log and the per-kernel
profile are also written to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "src", "repro_torch", "fixtures")
FIXTURE = os.path.join(FIXTURES, "serving_t25_d6")
BRANCHES = ("serving_branches/multiclass_2hosts", "serving_branches/mo")

# H100 SXM published peaks: HBM3 bandwidth, and fp32 outside the tensor
# cores (the rate a compare runs at)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

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

    build_logs = {}
    for name in build.sources():
        t0 = time.perf_counter()
        build_logs[name] = build.build(name)
        print(f"build: {name}.cu in {time.perf_counter() - t0:.2f} s",
              flush=True)
        for line in build_logs[name].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    ref = np.load(os.path.join(FIXTURE, "reference.npz"))
    X = serving_batch(ref, N_BIG)
    if not np.array_equal(X[:int(ref["n"])],
                          serving_batch(ref, int(ref["n"]))):
        fail("the 1M batch does not extend the reference batch")
    thr_g = load_guest(os.path.join(FIXTURE, "guest"), dev).thresholds
    thr_h = load_host(os.path.join(FIXTURE, "host0"), dev).thresholds

    krows = kernel_phase(torch, dev, thr_g, thr_h, X)
    pred, serving = serving_phase(torch, dev, ref, X)
    branches = branch_phase(torch, dev)
    n_g = int(ref["n_guest"])
    latency = [latency_phase(pred, X, n_g, int(ref["n"]), 100),
               latency_phase(pred, X, n_g, N_BIG, 8)]
    prof = [profile_phase(torch, pred, X, n_g, int(ref["n"]), 10),
            profile_phase(torch, pred, X, n_g, N_BIG, 2)]

    main_row = next(r for r in krows
                    if r["party"] == "host" and r["shape"][0] == N_BIG)
    kernels = {"kernels": [dict(
        name="bucketize", route="cuda",
        source="src/repro_torch/csrc/bucketize.cu",
        replaces="src/repro/kernels/binning/binning.py:30",
        launches=serving["launches"]["bucketize"],
        max_abs_err=max(r["max_abs_err"] for r in krows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"], shape=main_row["shape"],
        matches_plain=True)]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_logs=build_logs,
                           kernel_rows=krows, serving=serving,
                           branches=branches, latency=latency, profile=prof,
                           **kernels, device=device), f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
