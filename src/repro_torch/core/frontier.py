"""Device-resident frontier engine (DESIGN.md §7 of the JAX package).

The port of the JAX package's ``core/frontier.py`` for one device:

* :class:`FrontierState` -- the host's bin matrix and the width-padded
  ciphertext limb batch, placed on the device once per tree, and the cache
  of canonical parent histograms; all device tensors that persist across
  layers.
* :class:`CipherFrontier` -- the per-(tree, host) manager: builds the
  state, assembles the per-layer ``node_slot`` vector (a member-slot
  matrix for a round-forest layer), invokes the engine's layer
  accumulation, and owns histogram-cache insertion and eviction.
* :class:`GuestFrontier` -- the plaintext guest mirror (numpy float64; the
  guest never enters the cipher domain for its own features).

The out-of-core stream mode (``CtsBlocks``), the pipelining buffer
(``FrontierBuffer``), the mesh placement and the Paillier object-array
state are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .binning import BinnedData
from .he import limbs


@dataclasses.dataclass
class FrontierState:
    """Device-resident per-(tree, host) layer state.

    ``bins``: (n, n_f) int32 tensor.
    ``cts``:  (n, n_slots, width) int32 limb tensor, padded to the cipher's
              histogram width once per tree.
    ``hists``: {nid: canonical (n_f, n_b, n_slots, L) histogram tensor} --
              parent histograms cached for subtraction.
    """
    bins: torch.Tensor
    cts: torch.Tensor
    hists: dict


class CipherFrontier:
    """Frontier manager for one (tree, host) pair on the cipher engine.

    Construction happens once per tree, right after the encrypted-GH
    broadcast: the bin matrix moves to the ciphertexts' device and stays
    there with them; per layer only the small ``node_slot`` vector crosses
    the host boundary.
    """

    def __init__(self, engine, data: BinnedData, cts: torch.Tensor):
        self.engine = engine
        cipher = engine.cipher
        self.data = data
        self.counts: dict = {}          # nid -> (n_f, n_b) int64, plaintext
        bins_np = np.asarray(data.bins, np.int32)
        self.bins_np = bins_np          # host mirror for plaintext counts
        # ciphertexts born at histogram width (_encrypt_all) are adopted as
        # they are; anything narrower is padded here, one re-placement
        width = cipher.hist_width
        self.n_cts_placements = int(cts.shape[-1] != width)
        cts_wide = limbs.pad_limbs(cts, width)
        self.state = FrontierState(
            bins=torch.as_tensor(bins_np).to(cts_wide.device),
            cts=cts_wide, hists={})
        # flattened (n, slots*width) view for the kernel, once per tree
        self.cts_flat = cts_wide.reshape(cts_wide.shape[0], -1)
        if engine.stats is not None:
            # the whole int32 batch stays device-resident
            engine.stats.peak_cts_bytes = max(engine.stats.peak_cts_bytes,
                                              cts_wide.numel() * 4)

    # -- cache ----------------------------------------------------------
    def __contains__(self, nid) -> bool:
        return nid in self.state.hists

    def hist(self, nid):
        return self.state.hists[nid]

    def count(self, nid):
        return self.counts[nid]

    def store(self, nid, hist, cnt) -> None:
        self.state.hists[nid] = hist
        self.counts[nid] = cnt

    def evict(self, nids) -> None:
        for nid in nids:
            self.state.hists.pop(nid, None)
            self.counts.pop(nid, None)

    def evict_except(self, keep) -> int:
        """Drop every cached histogram whose nid is not in ``keep`` (the
        subtract-parents scheduled for the next layer): nodes that became
        leaves must not pin device memory for the tree's remainder.
        Returns the cache size after eviction."""
        self.evict([nid for nid in list(self.state.hists) if nid not in keep])
        return len(self.state.hists)

    # -- per-layer ------------------------------------------------------
    def layer_slots(self, node_rows: dict, direct: list) -> np.ndarray:
        """(n,) int32 direct-slot assignment aligned with the device bins:
        row -> index into ``direct`` (-1 = row not in any direct-mode
        frontier node this layer)."""
        node_slot = np.full(self.bins_np.shape[0], -1, np.int32)
        for k, nid in enumerate(direct):
            node_slot[node_rows[nid]] = k
        return node_slot

    def layer_slots_forest(self, node_rows: dict, direct: list, k: int,
                           stride: int):
        """Member-batched slot assignment for one round-forest layer.

        ``direct`` holds global node ids ``gid = member * stride + nid``; a
        row can sit in at most one direct node *per member tree*, so the
        assignment is a (n, k) matrix of member-local slots.  Returns
        ``(slot_mat, member_local, n_local)`` where ``member_local`` maps
        each gid to ``(member, local_slot)`` (local slots are assigned in
        ``direct`` order within each member) and ``n_local`` is the widest
        member's direct count -- the kernel's shared node extent.
        """
        slot_mat = np.full((self.bins_np.shape[0], k), -1, np.int32)
        member_local: dict = {}
        counts = [0] * k
        for gid in direct:
            m = int(gid) // stride
            member_local[gid] = (m, counts[m])
            slot_mat[node_rows[gid], m] = counts[m]
            counts[m] += 1
        return slot_mat, member_local, max(counts) if counts else 0

    def layer_histograms(self, node_rows: dict, direct: list,
                         subtract: list, forest: int = 0) -> dict:
        """All frontier histograms of one layer; caches the results for the
        next layer's subtraction.  Returns {nid: (hist, counts)}.

        ``forest > 0`` selects the round-forest launch: node ids in
        ``direct``/``subtract`` are global gids and the layer launch
        batches over (member tree, node)."""
        out = self.engine.layer_histograms(self, node_rows, direct, subtract,
                                           forest=forest)
        for nid, (h, c) in out.items():
            self.store(nid, h, c)
        return out


class GuestFrontier:
    """Plaintext guest-side frontier state: per-tree histogram cache for
    the guest's own features (numpy; no cipher domain)."""

    def __init__(self, engine, data: BinnedData, g, h):
        self.engine = engine
        self.data = data
        self.g = g
        self.h = h
        self.cache: dict = {}

    def __contains__(self, nid) -> bool:
        return nid in self.cache

    def evict(self, nids) -> None:
        for nid in nids:
            self.cache.pop(nid, None)

    def evict_except(self, keep) -> int:
        """See :meth:`CipherFrontier.evict_except`."""
        self.evict([nid for nid in list(self.cache) if nid not in keep])
        return len(self.cache)

    def layer_histograms(self, node_rows: dict, direct: list,
                         subtract: list) -> dict:
        hists = self.engine.layer_histograms(self.data, self.g, self.h,
                                             node_rows, direct, subtract,
                                             self.cache)
        self.cache.update(hists)
        return hists

    def cumsum(self, hist):
        return self.engine.cumsum(hist)
