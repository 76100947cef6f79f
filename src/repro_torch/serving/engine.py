"""Round-batched federated serving engine on PyTorch.

The port of the JAX package's ``serving/engine.py``, for in-process
halves.  It serves a whole batch through ALL trees at once with ONE wire
round-trip per host per batch:

1. **Bits.**  Each party bins its own features (the bucketize kernel on a
   card) and evaluates every internal node it owns for every instance:
   ``bits[j, i // 8]`` bit ``i % 8`` (little-endian within the byte) says
   instance ``i`` goes left at node-column ``j``.  The packed uint8 tensor
   is both the wire payload (1 bit per node per instance — what the byte
   ledger counts) and the routing operand.
2. **Combine.**  The guest concatenates the per-party row blocks — packed
   node ids ARE bit-tensor rows (``serving/packed.py``), so no scatter.
3. **Route.**  A layer-synchronous loop advances an (instance, tree)
   cursor ``depth`` times through the fused ``step[node, bit]`` table;
   leaves self-loop.
4. **Accumulate.**  Leaf weights are gathered in float64 and added per
   tree in training order, so the scores are bit-identical to the JAX
   engine's: routing is exact integer work, and elementwise float64 adds
   in the same order round the same on any IEEE device.

Bins, bits, cursors and scores stay on the serving device; only the
final scores come back to the host.  The mesh path and remote hosts
(``RemoteServingHost`` over the transport) are not ported yet.

Wire accounting uses the same :class:`Channel`/:class:`Stats` plumbing
and byte counts as the JAX engine: ``predict_req`` (guest -> host,
instance ids) and ``predict_bits`` (host -> guest, the packed bit block)
per host per batch, ``Stats.n_predict_roundtrips`` counting the latter.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..analysis import schema as wire
from ..analysis.registry import declassifies
from ..core.binning import BinnedData, apply_binning
from ..core.loss import sigmoid, softmax
from ..core.party import Channel, Stats
from ..device import resolve_device, to_device
from ..kernels.common import round_up


@declassifies("one comparison bit per (row, owned node): the serving "
              "protocol's unit of disclosure — never raw feature values")
def _packed_bits(bins_P, fid, bid):
    """All of one party's decision bits, one bit plane at a time.

    ``bins_P`` (n_f, 8, n_pad // 8) int32 holds the padded bins in
    bit-plane order: ``bins_P[f, b, j]`` is the bin of row ``8 j + b``, so
    each plane's gathered rows are contiguous.  ``fid`` (k,) int64 and
    ``bid`` (k, 1) int32 are the party's split table in bit-column order.
    Each byte is the weighted sum of its 8 bits, built plane by plane so
    the largest temporary is (k, n_pad // 8), not (k, n_pad).  Returns
    (k, n_pad // 8) uint8, bitorder little."""
    out = torch.zeros((fid.shape[0], bins_P.shape[2]), dtype=torch.uint8,
                      device=bins_P.device)
    for b in range(8):
        ge = bins_P[:, b].index_select(0, fid) <= bid
        out |= ge.view(torch.uint8) << b    # bool is one 0/1 byte
    return out


def _route(bits, step, node, depth: int):
    """Layer-synchronous traversal: advance the (instance, tree) cursor
    ``depth`` times.  ``bits`` (k, n_pad // 8) uint8; ``step`` (n_nodes, 2)
    int64 with leaves self-looping, so no leaf test is needed and leaf
    cursor entries read a clamped, ignored bit.  ``node`` (n_pad, n_trees)
    int64."""
    if bits.shape[0] == 0:
        # no internal node anywhere: every cursor already sits on a leaf
        return node
    rows = torch.arange(node.shape[0], device=node.device)[:, None]
    byte_ix = rows >> 3
    shift = (rows & 7).to(torch.uint8)
    kmax = bits.shape[0] - 1
    for _ in range(depth):
        b = (bits[node.clamp(max=kmax), byte_ix] >> shift) & 1
        node = step[node, b.long()]
    return node


class PartyBits:
    """One party's serving evaluator: bins its OWN features and computes
    its decision-bit block."""

    def __init__(self, table, thresholds, n_bins: int, device):
        self.device = device
        # binner view: reuses the BinnedData device-threshold cache
        self.binner = BinnedData(
            bins=torch.zeros((0, thresholds.shape[0]), dtype=torch.int32),
            thresholds=thresholds, n_bins=n_bins)
        self._fid = table.fid.to(device=device, dtype=torch.int64)
        self._bid = table.bid.to(device=device, dtype=torch.int32)[:, None]

    def bin(self, X) -> torch.Tensor:
        return apply_binning(X, self.binner, self.device)

    def packed(self, bins, n_pad: int) -> torch.Tensor:
        """(k, n_pad // 8) uint8 decision bits for one binned batch: the
        bins are padded and laid out in bit-plane order on the device."""
        bins = to_device(bins, torch.int32, self.device)
        n, n_f = bins.shape
        padded = torch.zeros((n_pad, n_f), dtype=torch.int32,
                             device=self.device)
        padded[:n] = bins
        bins_P = padded.view(n_pad // 8, 8, n_f).permute(2, 1, 0)
        return _packed_bits(bins_P.contiguous(), self._fid, self._bid)

    @declassifies("wrapper over _packed_bits: bins then packs to the "
                  "one-bit-per-node disclosure unit")
    def packed_from_X(self, X, n_pad: int) -> torch.Tensor:
        return self.packed(self.bin(X), n_pad)


class FederatedPredictor:
    """Serves batched predictions from packed per-party halves on
    ``device`` (default ``"cuda"``; ``"cpu"`` runs the kernels' plain
    versions).  All cross-party transfers go through ``channel`` with
    protocol-fidelity byte counts under the ``predict_*`` tags."""

    def __init__(self, guest, hosts, *, channel: Channel | None = None,
                 stats: Stats | None = None, device="cuda"):
        self.device = resolve_device(device)
        hosts = sorted(hosts, key=lambda h: h.hid)
        if len(hosts) != guest.n_hosts or any(
                h.hid != i for i, h in enumerate(hosts)):
            raise ValueError(
                f"guest half expects hosts 0..{guest.n_hosts - 1}, got "
                f"{[h.hid for h in hosts]}")
        k_parties = [int(k) for k in guest.k_parties.tolist()]
        if guest.guest.k != k_parties[0]:
            raise ValueError(
                f"guest split table has {guest.guest.k} nodes, k_parties "
                f"records {k_parties[0]}")
        for h in hosts:
            if h.table.k != k_parties[1 + h.hid]:
                raise ValueError(
                    f"host{h.hid} table has {h.table.k} nodes, guest half "
                    f"expects {k_parties[1 + h.hid]}")
        self.guest = guest
        self.hosts = hosts
        self.channel = channel if channel is not None else Channel()
        self.stats = stats if stats is not None else Stats()

        dev = self.device
        self._step = guest.step.to(device=dev, dtype=torch.int64)
        self._roots = guest.roots.to(device=dev, dtype=torch.int64)
        self._leaf_w = guest.leaf_w.to(device=dev, dtype=torch.float64)
        self._tree_class = [int(c) for c in guest.tree_class.tolist()]
        # per party: a PartyBits evaluator, or None for parties owning no
        # internal nodes
        self._bits = [PartyBits(guest.guest, guest.thresholds, guest.n_bins,
                                dev) if guest.guest.k else None]
        for h in hosts:
            self._bits.append(PartyBits(h.table, h.thresholds, h.n_bins, dev)
                              if h.table.k else None)

    # ------------------------------------------------------------------
    def predict_score(self, X_guest, X_hosts) -> np.ndarray:
        """Raw ensemble scores for one batch (one round-trip per host):
        (n,) float64 for binary, (n, n_classes) otherwise."""
        if len(X_hosts) != len(self.hosts):
            raise ValueError(f"expected {len(self.hosts)} host matrices, "
                             f"got {len(X_hosts)}")
        # a guest owning no internal nodes (e.g. layered mode) never needs
        # its bins — only the batch row count
        guest_bins = (self._bits[0].bin(X_guest)
                      if self._bits[0] is not None
                      else torch.zeros((len(X_guest), 0), dtype=torch.int32,
                                       device=self.device))
        return self._predict_core(guest_bins, list(X_hosts), binned=False)

    def predict_proba(self, X_guest, X_hosts) -> np.ndarray:
        s = self.predict_score(X_guest, X_hosts)
        return sigmoid(s) if self.guest.objective == "binary" else softmax(s)

    def predict_score_binned(self, guest_bins, host_bins: list
                             ) -> np.ndarray:
        """Serve one already-binned batch: the engine entry point shared by
        ``predict_score`` and from-bins measurements."""
        return self._predict_core(
            to_device(guest_bins, torch.int32, self.device),
            list(host_bins), binned=True)

    def _predict_core(self, guest_bins: torch.Tensor, host_parts: list,
                      binned: bool) -> np.ndarray:
        g = self.guest
        t0 = time.perf_counter()
        if len(host_parts) != len(self.hosts):
            raise ValueError(f"expected {len(self.hosts)} host matrices, "
                             f"got {len(host_parts)}")
        n = guest_bins.shape[0]
        self.stats.n_predict_batches += 1
        tracer = self.channel.tracer

        # pad instances to the next power of two, then to the packed-byte
        # granule — the JAX engine's rule, which the predict_req payload
        # carries, so both packages' requests and ledgers match.  Pad rows
        # route garbage and are sliced off before the weight gather.
        n_pad = round_up(1 << max(n - 1, 1).bit_length(), 8)

        blocks = []
        if self._bits[0] is not None:
            with tracer.span("serve_bins", cat="serve", rows=int(n)):
                blocks.append(self._bits[0].packed(guest_bins, n_pad))
        # one round-trip per host per batch: the request carries the
        # instance ids (+ the pad extent so both sides bucket alike), the
        # reply the packed bit block
        t_rt = time.perf_counter()
        req = {"ids": torch.arange(n, dtype=torch.int32, device=self.device),
               "n_pad": int(n_pad)}
        for i, h in enumerate(self.hosts):
            party = self._bits[1 + i]
            if party is None:
                continue                    # party owns no internal nodes
            self.channel.send("guest", f"host{h.hid}", wire.PREDICT_REQ,
                              req, n * 4)
            pb = (party.packed(host_parts[i], n_pad) if binned
                  else party.packed_from_X(host_parts[i], n_pad))
            k = pb.shape[0]
            pb = self.channel.send(f"host{h.hid}", "guest",
                                   wire.PREDICT_BITS, pb, k * ((n + 7) // 8))
            self.stats.n_predict_roundtrips += 1
            blocks.append(pb)
        tracer.complete("serve_roundtrip", int(t_rt * 1e9),
                        int((time.perf_counter() - t_rt) * 1e9),
                        cat="serve", hosts=len(self.hosts))

        if blocks and g.depth > 0:
            with tracer.span("serve_route", cat="serve", rows=int(n),
                             trees=int(g.n_trees)):
                bits = (blocks[0] if len(blocks) == 1
                        else torch.cat(blocks, dim=0))
                node0 = self._roots.expand(n_pad, g.n_trees)
                node = _route(bits, self._step, node0, g.depth)[:n]
        else:                               # every tree is a lone leaf
            node = self._roots.expand(n, g.n_trees)

        # float accumulation replays the JAX engine's per-tree order
        # exactly (never a pairwise ``sum`` over the tree axis)
        w = self._leaf_w[node]              # (n, n_trees, w_dim)
        if g.objective == "binary":
            score = torch.full((n,), g.init_score, dtype=torch.float64,
                               device=self.device)
            for t in range(g.n_trees):
                score += w[:, t, 0]
        elif g.objective == "multiclass":
            score = to_device(g.init_score, torch.float64,
                              self.device).repeat(n, 1)
            for t in range(g.n_trees):
                score[:, self._tree_class[t]] += w[:, t, 0]
        else:                               # mo: vector leaves
            score = to_device(g.init_score, torch.float64,
                              self.device).repeat(n, 1)
            for t in range(g.n_trees):
                score += w[:, t]
        score = score.cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats.predict_seconds += dt
        tracer.complete("serve_batch", int(t0 * 1e9), int(dt * 1e9),
                        cat="serve", rows=int(n))
        return score
