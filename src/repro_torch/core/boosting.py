"""SecureBoost+ boosting loop (paper §3-§6) and the local baseline.

The port of the JAX package's ``core/boosting.py``.  ``VerticalBoosting``
orchestrates the guest and in-process hosts over a byte-counted channel,
with the host's ciphertext work on ``SBTParams.device`` (default
``"cuda"``: a card is required unless the caller asks for ``"cpu"``).  The
port runs the binary objective, the default tree mode and the ``plain``
and ``affine`` ciphers, with packing, histogram subtraction and
compression on (or off), one tree a round or a round-forest of
``forest_size`` bagged member trees sharing one encrypted-GH broadcast;
each option it does not run yet raises ``NotImplementedError`` naming the
ROADMAP item that ports it, never quietly taking another path.

``LocalGBDT`` is the plaintext single-party baseline: identical binning,
gains and leaf weights, so the federated model with the plain cipher is
bit-identical to it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import encoding
from ..device import resolve_device
from ..obs import trace as obs_trace
from ..obs.trace import NULL_TRACER, Tracer
from .binning import BinnedData, bin_features
from .he import get_cipher
from .histogram import CipherHistogram
from .loss import LogLoss
from .party import Channel, Stats
from .tree import (FederatedTree, HostRuntime, NoPackCodec, PackedCodec,
                   TreeContext, grow_forest, grow_tree, predict_tree)


@dataclasses.dataclass
class SBTParams:
    n_trees: int = 10
    max_depth: int = 5
    learning_rate: float = 0.3
    lam: float = 1.0
    n_bins: int = 32
    min_leaf: int = 1
    min_gain: float = 1e-6
    objective: str = "binary"          # binary (multiclass | mo: M9)
    n_classes: int = 2
    cipher: str = "plain"              # plain | affine (paillier: M2)
    key_bits: int = 1024
    precision: int = encoding.DEFAULT_PRECISION
    goss: bool = False                 # M9
    packing: bool = True
    histogram_subtraction: bool = True
    compression: bool = True
    sparse: bool = False               # M9
    tree_mode: str = "default"         # default (mix | layered: M9)
    pipeline: bool = False             # M10
    forest_size: int = 1               # round-forest width: k bagged
                                       # trees a round share ONE enc_gh
                                       # round-trip; binary objective only
    forest_subsample: float = 0.8      # each member's bag fraction of the
                                       # selected rows
    seed: int = 0
    device: str = "cuda"               # the device the hosts' ciphertext
                                       # work runs on; "cpu" runs the
                                       # kernels' plain versions
    mesh: object = None                # multi-GPU: M12
    row_block: int = 0                 # out-of-core: M11
    trace: bool = False                # structured tracing: observation
                                       # only, never control flow


# option -> (value the port runs, ROADMAP item that ports the rest)
_UNPORTED = (
    ("objective", lambda v: v == "binary",
     "Queue 1 M9 (multiclass and mo objectives)"),
    ("cipher", lambda v: v in ("plain", "affine"),
     "Queue 1 M2 (Paillier oracle)"),
    ("tree_mode", lambda v: v == "default",
     "Queue 1 M9 (mix and layered tree modes)"),
    ("goss", lambda v: not v, "Queue 1 M9 (GOSS)"),
    ("sparse", lambda v: not v, "Queue 1 M9 (sparse-aware histograms)"),
    ("pipeline", lambda v: not v, "Queue 1 M10 (pipelining)"),
    ("mesh", lambda v: v is None, "Queue 1 M12 (multi-GPU)"),
    ("row_block", lambda v: not v, "Queue 1 M11 (out-of-core)"),
)


def check_ported(params: SBTParams) -> None:
    """Raise ``NotImplementedError`` for any option the port does not run
    yet, naming the ROADMAP item that ports it."""
    for name, ok, item in _UNPORTED:
        value = getattr(params, name)
        if not ok(value):
            raise NotImplementedError(
                f"SBTParams.{name}={value!r} is not ported to repro_torch "
                f"yet (ROADMAP {item})")


def cipher_kwargs(params: SBTParams) -> dict:
    """Cipher-construction kwargs from run params, as the JAX package
    derives them."""
    if params.cipher == "plain":
        return {"bits": max(params.key_bits, 256)}
    return {"key_bits": params.key_bits, "seed": params.seed}


def forest_bags(params: SBTParams, t: int, n_sel: int) -> list:
    """Round ``t``'s member bags: ``forest_size`` sorted row-position
    subsets of the ``n_sel`` selected rows, drawn from the stream keyed by
    the round's first absolute tree index, as the JAX package draws them
    (so a replayed round draws the same bags)."""
    k = params.forest_size
    if params.forest_subsample >= 1.0:
        return [np.arange(n_sel) for _ in range(k)]
    rng = np.random.default_rng((params.seed, t * k, 29))
    size = max(1, int(round(params.forest_subsample * n_sel)))
    return [np.sort(rng.choice(n_sel, size, replace=False))
            for _ in range(k)]


class VerticalBoosting:
    def __init__(self, params: SBTParams):
        if params.forest_size > 1 and params.objective != "binary":
            raise ValueError(
                "forest_size > 1 (round-forests) requires objective="
                "'binary': multiclass rounds already batch one tree per "
                "class and MO packs classes into slots")
        check_ported(params)
        self.params = params
        self.device = resolve_device(params.device)
        self.trees: list[FederatedTree] = []
        self.tree_class: list[int] = []
        self.channel = Channel()
        self.stats = Stats()
        self.tracer = NULL_TRACER
        self.init_score = None
        self._loss = None
        self._predictor = None            # cached packed serving engine
        self._predictor_n_trees = -1

    # ------------------------------------------------------------------
    # fit = begin_fit + boost_round per round + finish_fit: each round is a
    # boundary whose state is committed only once the round succeeded
    def fit(self, X_guest: np.ndarray, y: np.ndarray,
            X_hosts: list[np.ndarray]):
        score = self.begin_fit(X_guest, y, X_hosts)
        for t in range(self.params.n_trees):
            score = self.boost_round(t, score)
        return self.finish_fit(score)

    def begin_fit(self, X_guest: np.ndarray, y: np.ndarray,
                  X_hosts: list[np.ndarray]) -> np.ndarray:
        """Reset model state, bin features, init the loss/cipher; returns
        the initial score vector (the round-0 boundary state)."""
        p = self.params
        self.trees = []
        self.tree_class = []
        self.stats = Stats()
        self.channel.reset_accounting()
        if p.trace:
            self.tracer = Tracer("guest")
        elif obs_trace.current().enabled:
            self.tracer = obs_trace.current()
        else:
            self.tracer = NULL_TRACER
        self.channel.tracer = self.tracer
        self._predictor = None            # stale after refit
        self._predictor_n_trees = -1
        self.guest_data = self._bin(X_guest)
        self.host_data = [self._bin(Xh) for Xh in X_hosts]
        y = np.asarray(y, np.float64)
        self._y = y
        self._loss = LogLoss()
        self.init_score = self._loss.init_score(y)
        self.cipher = get_cipher(p.cipher, **cipher_kwargs(p))
        return np.full(len(y), self.init_score)

    def _bin(self, X) -> BinnedData:
        """Bin one party's features (a ``BinnedData`` passes through)."""
        if isinstance(X, BinnedData):
            return X
        return bin_features(X, self.params.n_bins, device=self.device)

    @property
    def trees_per_round(self) -> int:
        """Trees one ``boost_round`` appends (the resume-boundary unit)."""
        return max(1, self.params.forest_size)

    def boost_round(self, t: int, score: np.ndarray) -> np.ndarray:
        """Grow round ``t``'s tree(s) and return the updated score.  The
        input score is never mutated and the trees are appended only after
        every tree of the round finished; the bags and host shuffles are
        keyed by the absolute tree index, so a replayed round regrows
        bit-identical trees."""
        k = self.trees_per_round
        if len(self.trees) != t * k:
            raise RuntimeError(
                f"boost_round({t}) expects {t * k} trees, model has "
                f"{len(self.trees)} — rollback_to_round first")
        score = np.array(score, np.float64, copy=True)
        t0 = time.perf_counter()
        g, h = self._loss.grad_hess(self._y, score)
        if self.params.forest_size > 1:
            grown = self._grow_forest(self.cipher, g, h, t)
        else:
            grown = [grow_tree(self._tree_ctx(self.cipher, g, h,
                                              tree_idx=t))]
        for tree, leaf_rows in grown:
            self.trees.append(tree)
            self.tree_class.append(-1)
            self._apply(score, tree, leaf_rows)
        dt = time.perf_counter() - t0
        self.stats.tree_seconds.append(dt)
        self.tracer.complete("round", int(t0 * 1e9), int(dt * 1e9), round=t)
        return score

    def rollback_to_round(self, t: int) -> None:
        """Truncate the model to the round-``t`` boundary (replay)."""
        keep = t * self.trees_per_round
        del self.trees[keep:]
        del self.tree_class[keep:]
        del self.stats.tree_seconds[t:]
        self._predictor = None
        self._predictor_n_trees = -1

    def finish_fit(self, score: np.ndarray):
        self.train_score_ = score
        return self

    # ------------------------------------------------------------------
    def _make_hosts(self, cipher) -> list:
        p = self.params
        return [HostRuntime(hid=i, data=d,
                            engine=CipherHistogram(cipher, p.n_bins,
                                                   stats=self.stats,
                                                   tracer=self.tracer))
                for i, d in enumerate(self.host_data)]

    def _tree_ctx(self, cipher, g, h, tree_idx: int,
                  params=None) -> TreeContext:
        """One tree's (or round-forest's) context: every row selected
        (GOSS is not ported)."""
        sel = np.arange(g.shape[0])
        return TreeContext(params=params or self.params, cipher=cipher,
                           codec=self._make_codec(cipher, g[sel], h[sel]),
                           channel=self.channel, stats=self.stats,
                           guest_data=self.guest_data, g=g, h=h,
                           sel_rows=sel, device=self.device,
                           hosts=self._make_hosts(cipher), tree_idx=tree_idx)

    def _grow_forest(self, cipher, g, h, t: int) -> list:
        """One round-forest (FedGBF-style): ``forest_size`` bagged member
        trees sharing ONE enc_gh round-trip (``core/tree.py grow_forest``).
        Leaf weights grow with ``learning_rate / k``, so the round's
        additive update averages the members instead of overshooting k
        times.  Returns ``[(tree, leaf_rows), ...]``."""
        p = self.params
        k = p.forest_size
        bags = forest_bags(p, t, g.shape[0])
        fp = dataclasses.replace(p, learning_rate=p.learning_rate / k)
        ctx = self._tree_ctx(cipher, g, h, tree_idx=t * k, params=fp)
        return grow_forest(ctx, bags)

    def _make_codec(self, cipher, g, h):
        p = self.params
        if p.packing:
            plan = encoding.plan_packing(g, h, len(g), cipher.plaintext_bits,
                                         p.precision)
            return PackedCodec(plan)
        return NoPackCodec.plan(g, p.precision)

    # ------------------------------------------------------------------
    def _apply(self, score, tree: FederatedTree, leaf_rows: dict):
        """Training score update from the grower's train-side row->leaf
        map; ``leaf_rows`` never lives on the tree (serving/export must
        see no row-level state)."""
        for nd in tree.nodes:
            if nd.left == -1 and nd.weight is not None:
                score[leaf_rows[nd.nid]] += nd.weight

    def _serving_predictor(self):
        """Cached packed serving engine over this model's trees on the
        model's device, wired to the model's wire/stat ledgers (rebuilt if
        the trees changed)."""
        from ..serving import FederatedPredictor, PackedEnsemble
        if self._predictor is None \
                or self._predictor_n_trees != len(self.trees):
            ens = PackedEnsemble.from_model(self, device=self.device)
            self._predictor = FederatedPredictor(
                ens.guest, ens.hosts, channel=self.channel,
                stats=self.stats, device=self.device)
            self._predictor_n_trees = len(self.trees)
        return self._predictor

    def predict_score(self, X_guest, X_hosts,
                      packed: bool = True) -> np.ndarray:
        """Raw ensemble scores.  ``packed=True`` (default) serves through
        the port's packed engine on the model's device, one wire
        round-trip per host per batch, counted under the ``predict_*``
        tags.  ``packed=False`` keeps the per-node ``predict_tree`` loop
        as the slow oracle."""
        if packed and self.trees:
            return self._serving_predictor().predict_score(X_guest, X_hosts)
        from .binning import apply_binning
        gb = apply_binning(X_guest, self.guest_data, self.device)
        hb = [apply_binning(X, d, self.device).cpu().numpy()
              for X, d in zip(X_hosts, self.host_data)]
        gb = gb.cpu().numpy()
        score = np.full(gb.shape[0], self.init_score)
        for tree in self.trees:
            score += predict_tree(tree, gb, hb)
        return score

    def predict_proba(self, X_guest, X_hosts,
                      packed: bool = True) -> np.ndarray:
        from .loss import sigmoid
        return sigmoid(self.predict_score(X_guest, X_hosts, packed=packed))


# ---------------------------------------------------------------------------
# the local plaintext baseline ("XGBoost" role in the paper's tables)
# ---------------------------------------------------------------------------

class LocalGBDT(VerticalBoosting):
    """Single-party plaintext GBDT with identical binning/gain/weights.

    Implemented as federated training with zero hosts and the plain cipher:
    the protocol collapses to local histogram split finding, which makes the
    parity claim ('lossless', paper Table 3) checkable in one code path.
    """

    def __init__(self, params: SBTParams):
        params = dataclasses.replace(params, cipher="plain", packing=True,
                                     compression=False, tree_mode="default")
        super().__init__(params)

    def fit(self, X: np.ndarray, y: np.ndarray):   # type: ignore[override]
        return super().fit(X, y, [])

    def predict_score(self, X, packed: bool = True) -> np.ndarray:  # type: ignore[override]
        return super().predict_score(X, [], packed=packed)

    def predict_proba(self, X, packed: bool = True) -> np.ndarray:  # type: ignore[override]
        from .loss import sigmoid
        return sigmoid(self.predict_score(X, packed=packed))
