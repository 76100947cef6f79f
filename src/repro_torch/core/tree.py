"""Layer-wise federated decision-tree growth (paper §2.3, Algorithms 1-6).

The port of the JAX package's ``core/tree.py`` for one device and
in-process hosts.  :func:`grow_tree` runs the node-splitting protocol with
its optimizations (GH packing, histogram subtraction, cipher compressing)
layer by layer: per (layer, host) pair the protocol performs ONE launch of
the layer histogram kernel covering every direct-mode frontier node, ONE
``cipher.reduce``, ONE ciphertext cumsum, and ONE ``split_infos`` message
answered by ONE batched guest decrypt.  ``Stats.n_hist_launches`` and
``Stats.n_split_roundtrips`` count them.

The host's layer state lives on the device (``CipherFrontier``): bins and
ciphertext limbs are placed once per tree, parent histograms are cached as
device tensors, and the histograms, their cumsum, the shuffle and the
compression stay there until the guest decrypts.  The guest's own
plaintext histograms, the split search and the row bookkeeping are numpy
on the host, as in the reference, so the float64 sums come out the same
bit for bit; the node totals are summed in a pinned order
(``core/sums.py``), so they do not change with the numpy version.

Party boundaries are explicit: everything that crosses guest<->host goes
through ``ctx.channel.send`` with wire-fidelity byte counts (the same
ledger as the JAX package's), and HE work is tallied in ``ctx.stats``.
Host-side protocol logic lives in :class:`HostRuntime`: each guest->host
message is a payload handled by ``deliver(tag, payload)``, and each reply
is emitted through ``channel.send`` and picked up with ``collect(tag)``.

:func:`grow_forest` grows a round-forest, k bagged member trees in
lockstep off ONE ``enc_gh`` broadcast, each layer still one message pair
per host; :func:`grow_tree` is its one-member case.

Not ported yet: the pipelined encrypt pump, the chunked out-of-core
encrypt, the Paillier object path, the mesh and the process-per-party
transport.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Callable

import numpy as np
import torch

from ..analysis import schema as wire
from . import compress as compress_mod
from . import encoding, mo_encoding
from .binning import BinnedData
from .frontier import CipherFrontier, GuestFrontier
from .he import limbs
from .histogram import GID_STRIDE, CipherHistogram, PlainHistogram
from .party import Channel, Stats, ct_wire_bytes
from .split import (SplitCandidates, candidates_from_cumsum, decode_sid,
                    find_best_split, leaf_weight)
from .sums import pairwise_sum

GUEST = -1
LEAF = -2


# ---------------------------------------------------------------------------
# GH codecs: how (g, h) become plaintexts and come back as sums
# ---------------------------------------------------------------------------

class PackedCodec:
    """SecureBoost+ default: one packed plaintext per instance (Alg 3/6)."""

    def __init__(self, plan: encoding.PackingPlan):
        self.plan = plan
        self.n_slots = 1
        self.compressible = True
        self.b_slot = plan.b_gh
        self.eta_s = plan.compress_capacity

    def encode_plain(self, g, h) -> np.ndarray:
        return encoding.pack_gh(g, h, self.plan)[:, None, :]   # (n, 1, Lp)

    def decode(self, ints: np.ndarray, counts: np.ndarray):
        g_l = np.empty(len(counts)); h_l = np.empty(len(counts))
        for i, (row, c) in enumerate(zip(ints, counts)):
            g_l[i], h_l[i] = encoding.unpack_gh_int(int(row[0]), self.plan, int(c))
        return g_l, h_l


class NoPackCodec:
    """Legacy SecureBoost: separate [[g]] and [[h]] ciphertexts."""

    def __init__(self, r: int, g_off: float):
        self.r = r
        self.g_off = g_off
        self.n_slots = 2
        self.compressible = False

    @classmethod
    def plan(cls, g, r: int = encoding.DEFAULT_PRECISION):
        return cls(r=r, g_off=float(max(0.0, -float(np.min(g))))
                   if np.size(g) else 0.0)

    def encode_plain(self, g, h) -> np.ndarray:
        g_int = encoding.encode_int64(np.asarray(g, np.float64) + self.g_off, self.r)
        h_int = encoding.encode_int64(h, self.r)
        L = limbs.num_limbs_for_bits(70)
        out = np.stack([encoding._int64_to_limbs(g_int, L),
                        encoding._int64_to_limbs(h_int, L)], axis=1)
        return out                                              # (n, 2, L)

    def decode(self, ints: np.ndarray, counts: np.ndarray):
        scale = float(1 << self.r)
        g_l = np.asarray([int(r[0]) for r in ints], np.float64) / scale \
            - self.g_off * np.asarray(counts, np.float64)
        h_l = np.asarray([int(r[1]) for r in ints], np.float64) / scale
        return g_l, h_l


class MOCodec:
    """SecureBoost-MO: vector g/h packed across classes (Alg 7/8)."""

    def __init__(self, plan: mo_encoding.MOPackingPlan):
        self.plan = plan
        self.n_slots = plan.n_k
        self.compressible = False    # paper §7.3.2: compress disabled for MO

    def encode_plain(self, G, H) -> np.ndarray:
        return mo_encoding.pack_gh_mo(G, H, self.plan)          # (n, n_k, Lp)

    def decode(self, ints: np.ndarray, counts: np.ndarray):
        l = self.plan.n_classes
        g_l = np.empty((len(counts), l)); h_l = np.empty((len(counts), l))
        for i, (row, c) in enumerate(zip(ints, counts)):
            g_l[i], h_l[i] = mo_encoding.unpack_gh_mo_ints(
                [int(x) for x in row], self.plan, int(c))
        return g_l, h_l


# ---------------------------------------------------------------------------
# runtime state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Node:
    nid: int
    depth: int
    party: int = LEAF            # GUEST / host id / LEAF
    fid: int = -1                # guest splits only (host fids stay private)
    bid: int = -1
    sid: int = -1                # host splits: shuffled id (host resolves)
    left: int = -1
    right: int = -1
    weight: np.ndarray | float | None = None
    gain: float = 0.0
    n_rows: int = 0

    @property
    def is_leaf(self) -> bool:
        return self.party == LEAF


@dataclasses.dataclass
class FederatedTree:
    nodes: list
    host_tables: list            # per host: {nid: (fid, bid)} -- host-private

    def node_arrays(self) -> dict:
        """Flat per-node arrays for the serving packer (serving/packed.py).

        Returns structure (party/left/right/depth), the guest's own
        (fid, bid) pairs, and the (n_nodes, w_dim) leaf-weight matrix
        (zeros at internal nodes).  Host split tables stay in
        ``host_tables`` — they are exported by the *host* half only.
        Deliberately contains nothing row-level: a packed model must be
        shippable to a serving process with no training-set residue.
        """
        nodes = self.nodes
        n = len(nodes)
        party = np.fromiter((nd.party for nd in nodes), np.int32, n)
        left = np.fromiter((nd.left for nd in nodes), np.int32, n)
        right = np.fromiter((nd.right for nd in nodes), np.int32, n)
        depth = np.fromiter((nd.depth for nd in nodes), np.int32, n)
        fid = np.fromiter((nd.fid for nd in nodes), np.int32, n)
        bid = np.fromiter((nd.bid for nd in nodes), np.int32, n)
        first_w = next(np.asarray(nd.weight, np.float64)
                       for nd in nodes if nd.weight is not None)
        weight = np.zeros((n, first_w.size), np.float64)
        for nd in nodes:
            if nd.weight is not None:
                weight[nd.nid] = np.asarray(nd.weight,
                                            np.float64).reshape(-1)
        return {"party": party, "left": left, "right": right,
                "depth": depth, "fid": fid, "bid": bid, "weight": weight}

    def signature(self) -> tuple:
        """Hashable, exact digest of the tree: structure, guest splits,
        host shuffled split ids, and the raw float64 leaf-weight bits.
        Two trees are bit-identical iff their signatures are equal; the
        JAX package's ``FederatedTree.signature`` gives the same tuple for
        the same tree."""
        return tuple(
            (nd.nid, nd.depth, nd.party, nd.fid, nd.bid, nd.sid,
             nd.left, nd.right,
             None if nd.weight is None else
             np.asarray(nd.weight, np.float64).tobytes())
            for nd in self.nodes)


@dataclasses.dataclass
class HostRuntime:
    """One host party: private data + the host side of the protocol.

    In-process, the instance doubles as the guest's handle: ``deliver``
    runs the handler synchronously and ``collect`` pops the reply the
    handler emitted.  Handler inputs and replies are payloads (numpy
    arrays, limb tensors, plain python), never shared live objects.
    """

    hid: int
    data: BinnedData
    engine: CipherHistogram      # fresh per tree
    frontier: CipherFrontier | None = None   # device-resident layer state
    perms: dict = dataclasses.field(default_factory=dict)
    table: dict = dataclasses.field(default_factory=dict)
    params: object = None        # wired by bind()
    cipher: object = None
    channel: Channel | None = None
    stats: Stats | None = None
    codec: object = None         # packing view from the enc_gh payload
    shuffle_rng: object = None   # host-PRIVATE split-id shuffle stream
    _outbox: dict = dataclasses.field(default_factory=dict)

    # -- wiring ---------------------------------------------------------
    def bind(self, params, cipher, channel, stats) -> None:
        """Attach the run context (in-process: the guest's own objects,
        one shared ledger and one Stats)."""
        self.params, self.cipher = params, cipher
        self.channel, self.stats = channel, stats

    def deliver(self, tag: str, payload) -> None:
        {wire.ENC_GH: self.begin_tree,
         wire.ASSIGN_SYNC: self.on_assign_sync,
         wire.CHOSEN_SID: self.on_chosen_sid}[tag](payload)

    def collect(self, tag: str):
        """Pop the pending reply the last handler emitted for ``tag``."""
        return self._outbox[tag].pop(0)

    def _reply(self, tag: str, payload, nbytes: int) -> None:
        self.channel.send(f"host{self.hid}", "guest", tag, payload, nbytes)
        self._outbox.setdefault(tag, []).append(payload)

    # -- handlers (Algorithm 5, host side) ------------------------------
    def begin_tree(self, msg: dict) -> None:
        """enc_gh: adopt the encrypted GH batch, restrict the binned view
        to the synced selected ids so row positions align with the
        ciphertext batch, and build the device-resident frontier."""
        sel = np.asarray(msg["sel_rows"])
        self.codec = types.SimpleNamespace(**msg["codec"])
        # host-private shuffle stream: deterministic per (seed, tree, hid),
        # the JAX package's stream, so both permute split ids alike
        self.shuffle_rng = np.random.default_rng(
            (int(msg["seed"]), 23, int(msg["tree"]), self.hid))
        self.perms = {}
        self.table = {}
        view = dataclasses.replace(self.data, bins=self.data.bins[sel])
        self.frontier = CipherFrontier(self.engine, view, msg["cts"])
        if self.stats is not None:
            self.stats.n_cts_placements += self.frontier.n_cts_placements

    def on_assign_sync(self, plan: dict) -> None:
        """One layer, batched: one histogram launch, one ``cipher.reduce``,
        one ciphertext cumsum, one shuffle/compress pass, ONE
        ``split_infos`` reply.  Everything up to the reply is queued on the
        device; the guest's decrypt is the first thing to wait on it."""
        p = self.params
        t0_host = time.perf_counter()
        splittable = [int(nid) for nid in plan["splittable"]]
        forest = int(plan.get("forest", 0))

        # prune the parent-histogram cache to exactly this layer's
        # subtract parents, BEFORE the empty-layer return (in-process this
        # shadows the guest's own eviction)
        if self.frontier is not None:
            keep = ({int(par) for _, mode, par, _ in plan["modes"]
                     if mode == "subtract"}
                    if p.histogram_subtraction else set())
            size = self.frontier.evict_except(keep)
            self.stats.peak_hist_cache = max(self.stats.peak_hist_cache,
                                             size)
        if not splittable:
            return
        codec, cipher = self.codec, self.cipher
        engine = self.engine
        node_of = np.asarray(plan["node_of"])
        hist_mode = {int(nid): (mode, int(par), int(sib))
                     for nid, mode, par, sib in plan["modes"]}
        n_f, n_b = self.data.n_features, p.n_bins
        n_slots = codec.n_slots

        direct, subtract = _resolve_modes(splittable, hist_mode,
                                          self.frontier,
                                          p.histogram_subtraction)
        if forest:
            # round-forest plan: node_of is (n_sel, k) and node ids are gids
            node_rows = {nid: np.where(node_of[:, nid // GID_STRIDE]
                                       == nid)[0] for nid in splittable}
        else:
            node_rows = {nid: np.where(node_of == nid)[0]
                         for nid in splittable}
        hists = self.frontier.layer_histograms(node_rows, direct, subtract,
                                               forest=forest)
        for nid in direct:
            self.stats.n_hom_add += int(hists[nid][1].sum()) * n_slots
        self.stats.n_hom_add += len(subtract) * n_f * n_b * n_slots

        # batched cumsum over the node axis, then per-node shuffle + concat
        # (the histograms stay on the device)
        stack = torch.stack([hists[nid][0] for nid in splittable])
        cum = engine.cumsum(stack)
        self.stats.n_hom_add += len(splittable) * n_f * (n_b - 1) * n_slots

        m = n_f * (n_b - 1)          # candidates per node (fixed)
        fid_grid, bid_grid = np.meshgrid(np.arange(n_f), np.arange(n_b - 1),
                                         indexing="ij")
        real_sids = (fid_grid * n_b + bid_grid).reshape(-1)
        flats, counts_l = [], []
        for k, nid in enumerate(splittable):
            # flatten to split infos, drop last bin (empty right side)
            flat = cum[k][:, : n_b - 1].reshape(m, n_slots, -1)
            fc = hists[nid][1].cumsum(axis=1)[:, : n_b - 1].reshape(-1)
            # real sids use the same fid*n_b+bid encoding as decode_sid
            perm = self.shuffle_rng.permutation(m)
            self.perms[nid] = real_sids[perm]  # shuffled position -> real sid
            flats.append(flat[torch.as_tensor(perm, device=flat.device)])
            counts_l.append(fc[perm])
        self.stats.n_split_infos += m * len(splittable)
        flat_all = torch.cat(flats, dim=0)
        counts_all = np.concatenate(counts_l)
        M = m * len(splittable)

        ct_bytes = ct_wire_bytes(cipher)
        use_compress = (p.compression and codec.compressible
                        and codec.eta_s > 1)
        if use_compress:
            eta = codec.eta_s
            pkgs, sizes = compress_mod.compress_batch(
                cipher, flat_all[:, 0, :], eta, codec.b_slot)
            n_pkgs = len(sizes)
            self.stats.n_hom_scalar += int(np.sum(sizes - 1))
            self.stats.n_hom_add += int(np.sum(sizes - 1))
            payload = {"data": pkgs, "sizes": sizes, "counts": counts_all,
                       "m": m}
            nbytes = n_pkgs * ct_bytes + M * 8
            self.stats.n_packages += n_pkgs
        else:
            payload = {"data": flat_all, "sizes": None, "counts": counts_all,
                       "m": m}
            nbytes = M * n_slots * ct_bytes + M * 8
            self.stats.n_packages += M * n_slots
        self._reply(wire.SPLIT_INFOS, payload, nbytes)
        self.channel.tracer.complete(
            "host_layer", int(t0_host * 1e9),
            int((time.perf_counter() - t0_host) * 1e9),
            tree=int(plan.get("tree", -1)), nodes=len(splittable))

    def on_chosen_sid(self, msg: dict) -> None:
        """The guest committed to one of this host's shuffled candidates:
        resolve it against the private permutation, record the (fid, bid)
        in the host-private table, and answer with the go-left bitmask
        over the node's instance space."""
        nid, sid = int(msg["nid"]), int(msg["sid"])
        rows = np.asarray(msg["rows"])
        real_sid = int(self.perms[nid][sid])
        fid, bid = decode_sid(real_sid, self.params.n_bins)
        self.table[nid] = (fid, bid)
        go_left = self.data.bins[rows, fid] <= bid
        self._reply(wire.ASSIGN_MASK, go_left, (len(go_left) + 7) // 8)


@dataclasses.dataclass
class TreeContext:
    params: object               # SBTParams (see boosting.py)
    cipher: object
    codec: object
    channel: Channel
    stats: Stats
    guest_data: BinnedData
    g: np.ndarray                # (n,) or (n, l)
    h: np.ndarray
    sel_rows: np.ndarray         # selected row ids (into full set)
    device: torch.device         # where the ciphertexts are made and kept
    hosts: list = dataclasses.field(default_factory=list)
    tree_idx: int = 0            # global tree counter (host shuffle seeds)


def _encrypt_all(ctx: TreeContext, g_sel: np.ndarray,
                 h_sel: np.ndarray) -> None:
    """Guest packs + encrypts g/h of selected rows, broadcasts to hosts.

    The packed plaintext limbs go to the device once; the ciphertexts are
    born there at histogram width (the affine cipher's ``encrypt_limbs``
    is ``kernels.modmul.encrypt_batch``: three K2 products), and each
    host's :class:`CipherFrontier` adopts the tensor as it is.  The
    wire-byte ledger keeps protocol-fidelity counts via ``ct_wire_bytes``
    regardless of the in-memory limb layout."""
    t0 = time.perf_counter()
    plain = ctx.codec.encode_plain(g_sel, h_sel)
    n, s, _ = plain.shape
    plain_dev = torch.as_tensor(plain, dtype=torch.int32).to(ctx.device)
    cts = limbs.pad_limbs(ctx.cipher.encrypt_limbs(plain_dev),
                          ctx.cipher.hist_width)
    ctx.stats.n_encrypt += n * s
    dt = time.perf_counter() - t0
    ctx.stats.encrypt_seconds += dt
    ctx.channel.tracer.complete("encrypt", int(t0 * 1e9), int(dt * 1e9),
                                tree=int(ctx.tree_idx), rows=int(n))
    nbytes = n * s * ct_wire_bytes(ctx.cipher) + n * 4   # + selected row ids
    codec_view = {"n_slots": int(ctx.codec.n_slots),
                  "compressible": bool(ctx.codec.compressible),
                  "eta_s": int(getattr(ctx.codec, "eta_s", 0)),
                  "b_slot": int(getattr(ctx.codec, "b_slot", 0))}
    payload = {"tree": int(ctx.tree_idx), "seed": int(ctx.params.seed),
               "sel_rows": ctx.sel_rows, "codec": codec_view, "cts": cts}
    for host in ctx.hosts:
        host.bind(ctx.params, ctx.cipher, ctx.channel, ctx.stats)
        ctx.channel.send("guest", f"host{host.hid}", wire.ENC_GH, payload,
                         nbytes)
        host.deliver(wire.ENC_GH, payload)


def _resolve_modes(splittable: list, hist_mode: dict, cache,
                   subtraction_on: bool) -> tuple[list, list]:
    """Partition a layer's splittable nodes into direct / subtract batches.

    ``cache`` is any container answering ``nid in cache`` for cached parent
    histograms (a ``CipherFrontier`` / ``GuestFrontier``).  A node keeps its
    scheduled "subtract" mode only when its parent's histogram is cached AND
    its (direct-mode) sibling is being computed this layer -- otherwise it
    falls back to direct.  ``splittable`` must be ordered direct-first so
    siblings are classified before their subtract partners."""
    direct: list = []
    subtract: list = []
    direct_set: set = set()
    for nid in splittable:
        mode, par, sib = hist_mode[nid] if subtraction_on \
            else ("direct", -1, -1)
        if mode == "subtract" and par in cache and sib in direct_set:
            subtract.append((nid, par, sib))
        else:
            direct.append(nid)
            direct_set.add(nid)
    return direct, subtract


def _host_layer_finish(ctx: TreeContext, hid: int,
                       splittable: list, pending: dict) -> dict:
    """Guest side of the layer batch: ONE batched decrypt + decode
    (Algorithm 6) of the candidate stack a host answered ``assign_sync``
    with (``HostRuntime.on_assign_sync``).  The stack is still on the
    device, and copying it to the host waits for the host's whole queued
    layer.  Returns {nid: SplitCandidates}."""
    n_slots = ctx.codec.n_slots
    data, sizes, cl = pending["data"], pending["sizes"], pending["counts"]
    m = int(pending["m"])
    M = m * len(splittable)
    if sizes is not None:
        plain = _decrypt_ints(ctx, data)
        ctx.stats.n_decrypt += len(plain)
        vals = compress_mod.decompress_ints(
            plain, sizes, ctx.codec.eta_s, ctx.codec.b_slot, padded=True)
        rows = np.asarray(vals, dtype=object).reshape(M, 1)
    else:
        plain = _decrypt_ints(ctx, data.reshape(M * n_slots, -1))
        ctx.stats.n_decrypt += M * n_slots
        rows = np.asarray(plain, dtype=object).reshape(M, n_slots)
    g_l, h_l = ctx.codec.decode(rows, cl)
    out = {}
    for k, nid in enumerate(splittable):
        sl = slice(k * m, (k + 1) * m)
        out[nid] = SplitCandidates(party=hid, sid=np.arange(m),
                                   g_l=g_l[sl], h_l=h_l[sl], cnt_l=cl[sl])
    return out


def _decrypt_ints(ctx: TreeContext, cts) -> list:
    """The guest's batched decrypt of a candidate stack still on the
    device, then python ints on the host (the affine cipher decrypts
    through ``kernels.modmul.decrypt_batch``: three K2 products)."""
    return ctx.cipher.decrypt_to_ints(cts)


def _guest_layer_candidates(ctx: TreeContext, guest_frontier: GuestFrontier,
                            splittable: list, rows_sel: dict,
                            hist_mode: dict) -> dict:
    """Guest-side plaintext mirror of the layer batch: one composite
    ``np.add.at`` pass for all direct nodes, subtraction for the rest."""
    direct, subtract = _resolve_modes(splittable, hist_mode, guest_frontier,
                                      ctx.params.histogram_subtraction)
    node_rows = {nid: ctx.sel_rows[rows_sel[nid]] for nid in splittable}
    hists = guest_frontier.layer_histograms(node_rows, direct, subtract)
    out = {}
    for nid in splittable:
        Gc, Hc, Cc = guest_frontier.cumsum(hists[nid])
        out[nid] = candidates_from_cumsum(Gc, Hc, Cc, party=GUEST)
    return out


# ---------------------------------------------------------------------------
# the grower
# ---------------------------------------------------------------------------

def grow_tree(ctx: TreeContext,
              feature_parties: Callable[[int], tuple] | None = None
              ) -> tuple:
    """Grow one federated tree.  ``feature_parties(depth) -> (use_guest,
    host_ids)`` schedules which parties contribute split candidates at each
    depth; default: everyone, every depth.

    Returns ``(tree, leaf_rows)``: the model and the training row -> leaf
    assignment.  ``leaf_rows`` is train-side state consumed once by the
    boosting loop's score update — it is deliberately NOT attached to the
    :class:`FederatedTree`, so a model held for serving (or exported via
    ``serving/export.py``) carries no row-level training residue.  This is
    :func:`grow_forest` with one member whose bag is every selected row;
    its plans carry no member axis, so its layers launch the layer
    histogram kernel."""
    return grow_forest(ctx, [np.arange(len(ctx.sel_rows))],
                       feature_parties)[0]


def grow_forest(ctx: TreeContext, bags: list,
                feature_parties: Callable[[int], tuple] | None = None
                ) -> list:
    """Grow one round-forest: ``k = len(bags)`` bagged member trees that
    share ONE ``enc_gh`` broadcast (FedGBF-style round bagging).
    ``bags[m]`` holds member m's row subset as positions into
    ``ctx.sel_rows``; bags restrict only which rows *contribute* g/h to
    split finding — every training row still routes through every member
    for the score update, so ``rows_all`` starts at the full set per member.

    All members grow in lockstep, layer by layer.  Each layer is ONE
    ``assign_sync`` -> ONE ``split_infos`` -> ONE batched decrypt per host:
    for k > 1 the assignment matrix gains a member column, the histogram
    launch batches over (member, node) through the forest kernel, and node
    ids on the wire are globals ``gid = member * GID_STRIDE + local_nid``
    (host dicts key on the opaque gid; the guest demuxes the hosts' split
    tables per member at the end).  k trees cost one encrypt round-trip and
    O(depth) protocol round trips, not O(k * depth).  With k = 1 every gid
    is the local nid and the plans are :func:`grow_tree`'s.

    Returns ``[(tree, leaf_rows), ...]`` per member, the pair
    :func:`grow_tree` returns.
    """
    p = ctx.params
    k = len(bags)
    forest = k if k > 1 else 0          # the plans' member axis, if any
    t_tree = time.perf_counter()
    if feature_parties is None:
        feature_parties = lambda d: (True, [h.hid for h in ctx.hosts])

    # hoisted once per round: g/h restricted to the selection
    g_sel = ctx.g[ctx.sel_rows]
    h_sel = ctx.h[ctx.sel_rows]

    if any(feature_parties(d)[1] for d in range(p.max_depth)):
        _encrypt_all(ctx, g_sel, h_sel)

    guest_frontier = GuestFrontier(PlainHistogram(p.n_bins), ctx.guest_data,
                                   ctx.g, ctx.h)

    n_all = ctx.guest_data.n_instances
    # per-member node lists carry LOCAL nids; all protocol/guest dict state
    # (rows, modes, caches, host tables) keys on the global gid
    nodes = [[Node(nid=0, depth=0, n_rows=n_all)] for _ in range(k)]
    rows_all: dict = {}
    rows_sel: dict = {}                  # positions into the sel arrays
    hist_mode: dict = {}
    frontier: list = []
    for m in range(k):
        gid0 = m * GID_STRIDE
        rows_all[gid0] = np.arange(n_all)
        rows_sel[gid0] = np.asarray(bags[m])
        hist_mode[gid0] = ("direct", -1, -1)
        frontier.append(gid0)

    for depth in range(p.max_depth):
        use_guest, host_ids = feature_parties(depth)
        active_hosts = [h for h in ctx.hosts if h.hid in host_ids]
        next_frontier = []
        # order: direct nodes before subtract nodes (siblings first)
        ordered = [n for n in frontier if hist_mode[n][0] == "direct"] + \
                  [n for n in frontier if hist_mode[n][0] == "subtract"]
        # sync one assignment per layer to hosts that participate: one
        # column per member, as a row sits in at most one frontier node of
        # each member tree (one vector for a single tree)
        if active_hosts:
            node_of = np.full((len(ctx.sel_rows), k), -1, np.int32)
            for gid in frontier:
                node_of[rows_sel[gid], gid // GID_STRIDE] = gid
            if not forest:
                node_of = node_of.ravel()

        # triage: nodes too small to split become leaves immediately; the
        # rest form this layer's batch
        splittable = []
        for gid in ordered:
            rs = rows_sel[gid]
            if len(rs) < 2 * p.min_leaf or len(rs) == 0:
                nodes[gid // GID_STRIDE][gid % GID_STRIDE].weight = \
                    leaf_weight(pairwise_sum(g_sel[rs]),
                                pairwise_sum(h_sel[rs]), p.lam,
                                p.learning_rate)
            else:
                splittable.append(gid)

        # one candidate batch per party for the whole layer: ONE
        # assign_sync plan per host, answered by ONE split_infos message.
        # The host's layer is queued on the device by deliver(); the
        # guest's plaintext numpy histograms run while it is in flight,
        # and only then does the guest wait on the batched decrypt.
        guest_cands: dict = {}
        host_cands: dict = {}
        t0 = time.perf_counter()
        if active_hosts:
            plan = {"tree": int(ctx.tree_idx),
                    "node_of": node_of,
                    "splittable": list(splittable),
                    "modes": [(gid,) + tuple(hist_mode[gid])
                              for gid in splittable]}
            if forest:
                plan["forest"] = forest
            for h in active_hosts:
                ctx.channel.send("guest", f"host{h.hid}", wire.ASSIGN_SYNC,
                                 plan, node_of.size * 4)
                h.deliver(wire.ASSIGN_SYNC, plan)
        if splittable:
            t1 = time.perf_counter()
            if use_guest and ctx.guest_data.n_features > 0:
                guest_cands = _guest_layer_candidates(
                    ctx, guest_frontier, splittable, rows_sel, hist_mode)
            t2 = time.perf_counter()
            for h in active_hosts:
                pend = h.collect(wire.SPLIT_INFOS)
                ctx.stats.n_split_roundtrips += 1
                host_cands[h.hid] = _host_layer_finish(ctx, h.hid,
                                                       splittable, pend)
            t3 = time.perf_counter()
            if active_hosts:
                ctx.stats.host_dispatch_seconds += t1 - t0
                ctx.stats.guest_hist_seconds += t2 - t1
                ctx.stats.host_wait_seconds += t3 - t2
                if guest_cands:
                    denom = t3 - t0
                    ctx.stats.layer_overlap.append(
                        (t2 - t1) / denom if denom > 0 else 0.0)
            tr = ctx.channel.tracer
            if tr.enabled:
                tkw = dict(tree=int(ctx.tree_idx), depth=int(depth))
                tr.complete("dispatch", int(t0 * 1e9), int((t1 - t0) * 1e9),
                            **tkw)
                tr.complete("guest_hist", int(t1 * 1e9),
                            int((t2 - t1) * 1e9), **tkw)
                tr.complete("decrypt_wait", int(t2 * 1e9),
                            int((t3 - t2) * 1e9), **tkw)
                tr.complete("layer", int(t0 * 1e9), int((t3 - t0) * 1e9),
                            nodes=len(splittable), **tkw)

        for gid in splittable:
            m = gid // GID_STRIDE
            node = nodes[m][gid % GID_STRIDE]
            rs = rows_sel[gid]
            G_tot = pairwise_sum(g_sel[rs])
            H_tot = pairwise_sum(h_sel[rs])

            cands = []
            if gid in guest_cands:
                cands.append(guest_cands[gid])
            for h in active_hosts:
                cands.append(host_cands[h.hid][gid])

            best = find_best_split(cands, G_tot, H_tot, len(rs), p.lam,
                                   p.min_leaf, p.min_gain)
            if best is None:
                node.weight = leaf_weight(G_tot, H_tot, p.lam, p.learning_rate)
                continue

            # resolve the split owner + instance assignment
            ra = rows_all[gid]
            fsel = ctx.sel_rows[rs]                 # full ids of selected rows
            if best.party == GUEST:
                fid, bid = decode_sid(best.sid, p.n_bins)
                go_left = ctx.guest_data.bins[ra, fid] <= bid
                go_left_sel = ctx.guest_data.bins[fsel, fid] <= bid
                node.party, node.fid, node.bid = GUEST, fid, bid
            else:
                # the chosen split id travels WITH the node's instance
                # space (the host resolves its private (fid, bid) and
                # answers one go-left bitmask over those rows); the
                # selected-row mask is derived guest-side — fsel is always
                # a subset of the ascending ra, so no second message
                host = next(h for h in ctx.hosts if h.hid == best.party)
                msg = {"nid": gid, "sid": best.sid, "rows": ra}
                ctx.channel.send("guest", f"host{host.hid}", wire.CHOSEN_SID,
                                 msg, 8 + 4 * len(ra))
                host.deliver(wire.CHOSEN_SID, msg)
                go_left = np.asarray(host.collect(wire.ASSIGN_MASK), bool)
                go_left_sel = go_left[np.searchsorted(ra, fsel)]
                node.party, node.sid = host.hid, best.sid
            node.gain = best.gain

            lid, rid = len(nodes[m]), len(nodes[m]) + 1
            gl, gr = m * GID_STRIDE + lid, m * GID_STRIDE + rid
            node.left, node.right = lid, rid
            rows_all[gl], rows_all[gr] = ra[go_left], ra[~go_left]
            rows_sel[gl], rows_sel[gr] = rs[go_left_sel], rs[~go_left_sel]
            nodes[m].append(Node(nid=lid, depth=depth + 1,
                                 n_rows=len(rows_all[gl])))
            nodes[m].append(Node(nid=rid, depth=depth + 1,
                                 n_rows=len(rows_all[gr])))
            # subtraction schedule: smaller child direct, sibling subtracts
            if len(rows_sel[gl]) <= len(rows_sel[gr]):
                hist_mode[gl] = ("direct", -1, -1)
                hist_mode[gr] = ("subtract", gid, gl)
            else:
                hist_mode[gr] = ("direct", -1, -1)
                hist_mode[gl] = ("subtract", gid, gr)
            next_frontier += [gl, gr]
        # free cached histograms: keep ONLY the parents the next layer's
        # subtract-mode nodes will read
        keep = ({hist_mode[c][1] for c in next_frontier
                 if hist_mode[c][0] == "subtract"}
                if p.histogram_subtraction else set())
        sizes = [guest_frontier.evict_except(keep)]
        for h in ctx.hosts:
            if h.frontier is not None:
                sizes.append(h.frontier.evict_except(keep))
        ctx.stats.peak_hist_cache = max(ctx.stats.peak_hist_cache,
                                        max(sizes))
        ctx.stats.peak_frontier = max(ctx.stats.peak_frontier, len(frontier))
        frontier = next_frontier

    # finalize: leaves at max depth, and the hosts' split tables demuxed
    # per member (gid -> local nid).  Leaf row assignments for the score
    # update are returned alongside, never retained on the model: a tree
    # must stay free of row-level state.
    tables_by_member = [[{} for _ in ctx.hosts] for _ in range(k)]
    for j, h in enumerate(ctx.hosts):
        for gid, fb in h.table.items():
            mm, loc = divmod(int(gid), GID_STRIDE)
            tables_by_member[mm][j][loc] = fb
    out = []
    for m in range(k):
        for node in nodes[m]:
            if node.left == -1 and node.weight is None:
                rs = rows_sel[m * GID_STRIDE + node.nid]
                node.weight = leaf_weight(pairwise_sum(g_sel[rs]),
                                          pairwise_sum(h_sel[rs]),
                                          p.lam, p.learning_rate)
        leaf_rows = {nd.nid: rows_all[m * GID_STRIDE + nd.nid]
                     for nd in nodes[m] if nd.left == -1}
        out.append((FederatedTree(nodes=nodes[m],
                                  host_tables=tables_by_member[m]),
                    leaf_rows))
    ctx.channel.tracer.complete(
        "tree", int(t_tree * 1e9),
        int((time.perf_counter() - t_tree) * 1e9),
        tree=int(ctx.tree_idx), n_nodes=sum(len(nm) for nm in nodes))
    return out


def predict_tree(tree: FederatedTree, guest_bins: np.ndarray,
                 host_bins: list) -> np.ndarray:
    """Route binned instances through the tree (simulation: reads host
    tables directly; the real protocol does the same lookups host-side)."""
    n = guest_bins.shape[0]
    first = next(nd for nd in tree.nodes if nd.weight is not None)
    w0 = np.asarray(first.weight)
    out = np.zeros((n,) + w0.shape)
    node_of = np.zeros(n, np.int64)
    changed = True
    while changed:
        changed = False
        for nd in tree.nodes:
            if nd.left == -1:
                continue
            sel = node_of == nd.nid
            if not sel.any():
                continue
            if nd.party == GUEST:
                go_left = guest_bins[sel, nd.fid] <= nd.bid
            else:
                fid, bid = tree.host_tables[nd.party][nd.nid]
                go_left = host_bins[nd.party][sel, fid] <= bid
            ids = np.where(sel)[0]
            node_of[ids[go_left]] = nd.left
            node_of[ids[~go_left]] = nd.right
            changed = True
    for nd in tree.nodes:
        if nd.left == -1 and nd.weight is not None:
            out[node_of == nd.nid] = nd.weight
    return out
