"""Histogram engines (paper Algorithms 1 & 5), node-level and
layer-batched.

The port of the JAX package's ``core/histogram.py``, for the paths the
port runs so far (dense features, one device, limb ciphers):

* :class:`CipherHistogram` -- host side.  The layer path accumulates the
  packed-GH ciphertexts of every direct-mode frontier node of one tree
  layer in ONE launch of the layer histogram kernel (``kernels/histogram``:
  lazy int32 limb sums over the composite index ``node_slot * n_bins +
  bin``), subtracts sibling histograms from cached parents in the
  still-lazy limb domain (``cipher.lazy_sub``), and canonicalizes the
  whole layer with ONE ``cipher.reduce``; the bin cumsum runs in the
  ciphertext domain.  The per-node path (``node_histogram`` and
  ``subtract``) accumulates one node's rows with one launch of the node
  histogram kernel (K5) and one reduce; no training path calls it, and it
  is the oracle the layer path is held to.  Every tensor stays on the
  ciphertexts' device.
* :class:`PlainHistogram` -- guest side (and the local baseline).  The
  same shapes in plaintext float64 via ``np.add.at`` on the host, exactly
  as the reference: float sums depend on order, so they stay in numpy to
  stay bit-identical.

Ciphertext batches carry a slot axis (SBT-MO packs ``n_k`` ciphertexts
per instance): cts are (n, n_slots, L) limbs and histograms (n_f, n_b,
n_slots, L).  A round-forest layer (``forest=k``) accumulates the direct
nodes of all k member trees in ONE launch of the forest histogram kernel
and gathers the member-major result back into ``direct`` order, so the
lazy subtraction, the reduce and the cumsum are the same.  The sparse
zero-bin recovery, the Paillier object path, the out-of-core stream and
the mesh dispatch are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.histogram import (ciphertext_histogram, count_histogram,
                                 forest_ciphertext_histogram,
                                 layer_ciphertext_histogram,
                                 layer_count_histogram)
from .binning import BinnedData
from .he import limbs

# Round-forest global node ids: gid = member * GID_STRIDE + member-local nid.
# Host-side dicts (histogram cache, shuffle perms, split tables) key on the
# opaque gid; k = 1 degenerates to gid == nid, i.e. the classic layer path.
GID_STRIDE = 1 << 20


class PlainHistogram:
    """Plaintext (g, h, count) histograms: (n_f, n_b) float64 / int64."""

    def __init__(self, n_bins: int):
        self.n_bins = n_bins

    def node_histogram(self, data: BinnedData, g: np.ndarray, h: np.ndarray,
                       rows: np.ndarray):
        """One node's (G, H, C) over ``rows``: the one-node case of
        :meth:`layer_histograms`, which adds in the same order as the
        reference's dense branch (sparse is not ported)."""
        return self.layer_histograms(data, g, h, {0: rows}, [0], [], {})[0]

    def layer_histograms(self, data: BinnedData, g: np.ndarray, h: np.ndarray,
                         node_rows: dict, direct: list, subtract: list,
                         cache: dict) -> dict:
        """Batched node histograms for one tree layer.

        node_rows: {nid: row ids}; direct: nids accumulated directly (one
        composite ``np.add.at`` pass per feature); subtract: (nid, parent,
        sibling) triples resolved as parent - sibling from ``cache`` /this
        layer's direct results.  Returns {nid: (G, H, C)}.
        """
        out = {}
        if direct:
            n_d, n_b = len(direct), self.n_bins
            rows_cat = np.concatenate([node_rows[nid] for nid in direct])
            slot_cat = np.concatenate(
                [np.full(len(node_rows[nid]), k, np.int64)
                 for k, nid in enumerate(direct)])
            n_f = data.n_features
            out_dim = np.asarray(g).shape[1:]
            G = np.zeros((n_f, n_d * n_b) + out_dim)
            H = np.zeros((n_f, n_d * n_b) + out_dim)
            C = np.zeros((n_f, n_d * n_b), np.int64)
            bins = data.bins[rows_cat]                # (r, n_f)
            gr, hr = g[rows_cat], h[rows_cat]
            comp = slot_cat[:, None] * n_b + bins     # composite (node, bin)
            for f in range(n_f):
                np.add.at(G[f], comp[:, f], gr)
                np.add.at(H[f], comp[:, f], hr)
                np.add.at(C[f], comp[:, f], 1)
            Gn = np.moveaxis(G.reshape((n_f, n_d, n_b) + out_dim), 1, 0)
            Hn = np.moveaxis(H.reshape((n_f, n_d, n_b) + out_dim), 1, 0)
            Cn = np.moveaxis(C.reshape(n_f, n_d, n_b), 1, 0)
            for k, nid in enumerate(direct):
                out[nid] = (Gn[k], Hn[k], Cn[k])
        for nid, par, sib in subtract:
            out[nid] = self.subtract(cache[par], out[sib])
        return out

    @staticmethod
    def subtract(parent, child):
        return tuple(p - c for p, c in zip(parent, child))

    @staticmethod
    def cumsum(hist):
        return tuple(np.cumsum(x, axis=1) for x in hist)


class CipherHistogram:
    """Ciphertext histograms over limb tensors on one device."""

    def __init__(self, cipher, n_bins: int, stats=None, tracer=None):
        from ..obs.trace import NULL_TRACER
        self.cipher = cipher
        self.n_bins = n_bins
        self.stats = stats          # optional party.Stats for launch counts
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def _count_launch(self):
        if self.stats is not None:
            self.stats.n_hist_launches += 1

    def node_histogram(self, data: BinnedData, cts: torch.Tensor,
                       rows: np.ndarray):
        """One node's histogram over ``rows`` (host row ids).

        cts: (n, n_slots, L) limb tensor; its device is where the work runs
        (a numpy array raises ``TypeError``: it is not placed anywhere
        quietly).  Returns (hist, counts): the canonical (n_f, n_b,
        n_slots, L) histogram tensor on that device and the (n_f, n_b)
        int64 plaintext counts."""
        if self.cipher.backend != "limb":
            raise NotImplementedError(
                f"node_histogram for the {self.cipher.name!r} cipher is not "
                f"ported yet (ROADMAP Queue 1 M2, the Paillier oracle)")
        if not torch.is_tensor(cts):
            raise TypeError(f"node_histogram takes cts as a tensor, got "
                            f"{type(cts).__name__}")
        rows = np.asarray(rows, np.int64)
        bins = np.asarray(data.bins, np.int32)[rows]
        counts = count_histogram(bins, self.n_bins).astype(np.int64)
        return self._limb_hist(bins, cts, rows), counts

    def _limb_hist(self, bins: np.ndarray, cts: torch.Tensor,
                   rows: np.ndarray) -> torch.Tensor:
        """One K5 launch over the node's rows, padded to the cipher's
        histogram width, then one reduce."""
        dev = cts.device
        sel = cts[torch.as_tensor(rows, device=dev)]
        n, n_slots, _ = sel.shape
        width = self.cipher.hist_width
        flat = limbs.pad_limbs(sel, width).reshape(n, n_slots * width)
        lazy = ciphertext_histogram(torch.as_tensor(bins, device=dev), flat,
                                    self.n_bins)
        self._count_launch()
        lazy = lazy.reshape(lazy.shape[0], self.n_bins, n_slots, width)
        return self.cipher.reduce(lazy)

    def subtract(self, parent, child):
        """Ciphertext histogram subtraction (§4.3): sibling = parent -
        child, on (hist, counts) pairs."""
        (ph, pc), (ch, cc) = parent, child
        return self.cipher.sub(ph, ch), pc - cc

    def layer_histograms(self, frontier, node_rows: dict, direct: list,
                         subtract: list, forest: int = 0) -> dict:
        """All frontier histograms of one tree layer in one batch.

        frontier:  a ``core.frontier.CipherFrontier`` -- the device-resident
                   layer state: bins and width-padded ciphertext limbs
                   (placed once per tree), plus the cache of canonical
                   parent histograms as device tensors.
        node_rows: {nid: row positions into the frontier's view}.
        direct:    nids accumulated directly -- ONE kernel launch for all.
        subtract:  (nid, parent, sibling) triples; the parent's canonical
                   histogram is read from the frontier cache, the sibling
                   must be in ``direct``.  Subtraction happens in the lazy
                   limb domain (``cipher.lazy_sub``) so a SINGLE
                   ``cipher.reduce`` canonicalizes direct and subtracted
                   nodes together.
        forest:    0 for the classic layer path; k > 0 means ``direct`` /
                   ``subtract`` hold gids of a k-member round-forest layer
                   (``gid = member * GID_STRIDE + nid``) and a row may sit
                   in one direct node *per member*: the accumulation runs
                   the (tree, node)-batched kernel, then the member-major
                   result is gathered back into ``direct`` order.
        Returns {nid: (hist, counts)}; the frontier owns cache writes.
        """
        n_f, n_b = frontier.data.n_features, self.n_bins
        slot_of = {nid: k for k, nid in enumerate(direct)}

        out = {}
        n_d = len(direct)
        counts = np.zeros((n_d, n_f, n_b), np.int64)
        lazy = None
        if n_d and forest:
            slot_mat, member_local, n_local = frontier.layer_slots_forest(
                node_rows, direct, forest, GID_STRIDE)
            cnts_m = [np.asarray(layer_count_histogram(
                frontier.bins_np, slot_mat[:, m], n_local, n_b)).astype(
                    np.int64) for m in range(forest)]
            for kk, gid in enumerate(direct):
                m, loc = member_local[gid]
                counts[kk] = cnts_m[m][loc]
            lazy_f = self._forest_dispatch(frontier, slot_mat, n_local)
            n_slots, width = frontier.state.cts.shape[1:]
            lazy_f = lazy_f.reshape(forest, n_local, n_f, n_b, n_slots,
                                    width)
            # gather the member-major blocks back into ``direct`` order
            t_idx = torch.as_tensor([member_local[gid][0] for gid in direct],
                                    device=lazy_f.device)
            s_idx = torch.as_tensor([member_local[gid][1] for gid in direct],
                                    device=lazy_f.device)
            lazy = lazy_f[t_idx, s_idx]     # (n_d, n_f, n_b, slots, width)
        elif n_d:
            node_slot = frontier.layer_slots(node_rows, direct)
            counts = np.asarray(layer_count_histogram(
                frontier.bins_np, node_slot, n_d, n_b)).astype(np.int64)
            lazy = self._layer_dispatch(frontier, node_slot, n_d)
            n, n_slots, width = frontier.state.cts.shape
            lazy = lazy.reshape(n_d, n_f, n_b, n_slots, width)

        # lazy subtraction, one reduce for the whole layer
        sub_lazy = [self.cipher.lazy_sub(frontier.hist(par),
                                         lazy[slot_of[sib]],
                                         len(node_rows[sib]))
                    for _, par, sib in subtract]
        parts = ([lazy] if n_d else []) + \
            ([torch.stack(sub_lazy)] if sub_lazy else [])
        if not parts:
            return out
        with self.tracer.span("carry_fix", nodes=n_d + len(subtract)):
            canon = self.cipher.reduce(torch.cat(parts, dim=0))
        for k, nid in enumerate(direct):
            out[nid] = (canon[k], counts[k])
        for j, (nid, par, sib) in enumerate(subtract):
            out[nid] = (canon[n_d + j],
                        frontier.count(par) - counts[slot_of[sib]])
        return out

    def _layer_dispatch(self, frontier, node_slot: np.ndarray, n_d: int):
        """One accumulation launch for the layer's direct nodes.  The JAX
        package pads the node axis to a power of two to cap ``jit``
        retraces; the port runs eagerly and launches with ``n_d`` nodes,
        which yields the same first ``n_d`` node histograms."""
        state = frontier.state
        flat = frontier.cts_flat          # flattened once per tree
        if self.stats is not None:
            self.stats.peak_block_bytes = max(
                self.stats.peak_block_bytes,
                (state.bins.numel() + int(node_slot.size)
                 + flat.numel()) * 4)
        slot_dev = torch.as_tensor(node_slot).to(flat.device)
        lazy = layer_ciphertext_histogram(state.bins, slot_dev, flat, n_d,
                                          self.n_bins)
        self._count_launch()
        return lazy

    def _forest_dispatch(self, frontier, slot_mat: np.ndarray,
                         n_local: int):
        """One (tree, node)-batched accumulation launch for a round-forest
        layer: the member axis rides through the kernel's grid.  Returns
        (k, n_local, n_f, n_b, L) lazy limb sums.  As in
        :meth:`_layer_dispatch`, the launch takes the real ``n_local``
        nodes, not the JAX package's power-of-two padding; the first
        ``n_local`` node histograms of each member are the same."""
        state = frontier.state
        flat = frontier.cts_flat
        if self.stats is not None:
            self.stats.peak_block_bytes = max(
                self.stats.peak_block_bytes,
                (state.bins.numel() + int(slot_mat.size)
                 + flat.numel()) * 4)
        slot_dev = torch.as_tensor(slot_mat).to(flat.device)
        lazy = forest_ciphertext_histogram(state.bins, slot_dev, flat,
                                           n_local, self.n_bins)
        self._count_launch()
        return lazy

    def cumsum(self, hist: torch.Tensor) -> torch.Tensor:
        """Prefix-sum over the bin axis in the ciphertext domain, for a
        single histogram (n_f, n_b, slots, L) or a layer-batched stack with
        any leading axes (..., n_f, n_b, slots, L).  The sum stays int32,
        as the reference's ``jnp.cumsum`` does."""
        wide = limbs.pad_limbs(hist, self.cipher.hist_width)
        return self.cipher.reduce(torch.cumsum(wide, dim=hist.dim() - 3,
                                               dtype=torch.int32))
