"""Packed ensembles for federated serving, holding device tensors.

The layout is the JAX package's (``serving/packed.py`` there):

* Internal nodes of ALL trees are numbered by **bit column**: guest-owned
  nodes first, then each host's block in hid order, each block ordered by
  (tree, nid).  A party's decision-bit tensor for a batch is therefore one
  contiguous row block, and the concatenated tensor needs no scatter.
* Leaves continue the numbering above the internal block and self-loop in
  the fused ``step`` table (``step[j] = [right, left]``, leaves
  ``[j, j]``), so routing needs no leaf test.
* The split *content* stays with its owner: the guest half carries tree
  structure, leaf weights, and only the guest's own (fid, bid) pairs; each
  host half carries only that host's (fid, bid) table and binning
  thresholds.

Halves are built from numpy fields (:meth:`PackedEnsemble.from_numpy`), in
the layout the export format stores them, so a model exported by either
package loads here through one code path.  Packing a trained port model
(``from_model``/``pack_guest``) comes with the training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device, to_device


@dataclasses.dataclass
class PartySlice:
    """One party's private routing table: (fid, bid) per owned internal
    node, ordered by that party's bit-column ids.  ``fid`` is local to the
    party's own feature space."""
    fid: torch.Tensor          # (k,) int32
    bid: torch.Tensor          # (k,) int32

    @property
    def k(self) -> int:
        return int(self.fid.shape[0])


@dataclasses.dataclass
class GuestHalf:
    """Everything the guest needs to serve: tree structure, leaf weights,
    its own splits, and its binning thresholds.  Contains NO host split
    content — only the per-party internal-node counts (``k_parties``),
    which fix each host's row block in the combined bit tensor."""
    step: torch.Tensor         # (n_nodes, 2) int32: [right, left]; leaves
                               # self-loop
    roots: torch.Tensor        # (n_trees,) int32 packed id of each root
    tree_class: torch.Tensor   # (n_trees,) int32; -1 for binary / MO
    leaf_w: torch.Tensor       # (n_nodes, w_dim) float64, 0 at internal ids
    depth: int                 # max node depth over all trees
    k_parties: torch.Tensor    # (1 + n_hosts,) int32 internal nodes per
                               # party, guest first
    guest: PartySlice
    thresholds: torch.Tensor   # guest binning table (n_f, n_b-1) fp32
    n_bins: int
    objective: str             # binary | multiclass | mo
    n_classes: int
    init_score: object         # float (binary) or (n_classes,) float64

    @property
    def n_nodes(self) -> int:
        return int(self.step.shape[0])

    @property
    def n_trees(self) -> int:
        return int(self.roots.shape[0])

    @property
    def n_hosts(self) -> int:
        return int(self.k_parties.shape[0]) - 1


@dataclasses.dataclass
class HostHalf:
    """Everything one host needs to serve: its split table (in bit-column
    order) and its binning thresholds.  No tree structure, no leaf
    weights, no other party's splits."""
    hid: int
    table: PartySlice
    thresholds: torch.Tensor
    n_bins: int


def _slice(fields: dict, dev: torch.device) -> PartySlice:
    return PartySlice(fid=to_device(fields["fid"], torch.int32, dev),
                      bid=to_device(fields["bid"], torch.int32, dev))


def guest_half_from_numpy(fields: dict, device="cuda") -> GuestHalf:
    """A :class:`GuestHalf` on ``device`` from the guest's numpy fields:
    the arrays ``step roots tree_class leaf_w k_parties fid bid
    thresholds`` and the values ``depth n_bins objective n_classes
    init_score`` (other keys are ignored).  A missing field raises
    ``KeyError``."""
    dev = resolve_device(device)
    objective = str(fields["objective"])
    init = fields["init_score"]
    return GuestHalf(
        step=to_device(fields["step"], torch.int32, dev),
        roots=to_device(fields["roots"], torch.int32, dev),
        tree_class=to_device(fields["tree_class"], torch.int32, dev),
        leaf_w=to_device(fields["leaf_w"], torch.float64, dev),
        depth=int(fields["depth"]),
        k_parties=to_device(fields["k_parties"], torch.int32, dev),
        guest=_slice(fields, dev),
        thresholds=to_device(fields["thresholds"], torch.float32, dev),
        n_bins=int(fields["n_bins"]), objective=objective,
        n_classes=int(fields["n_classes"]),
        init_score=(float(init) if objective == "binary"
                    else np.asarray(init, np.float64)))


def host_half_from_numpy(fields: dict, device="cuda") -> HostHalf:
    """A :class:`HostHalf` on ``device`` from one host's numpy fields:
    ``hid n_bins fid bid thresholds`` (other keys are ignored)."""
    dev = resolve_device(device)
    return HostHalf(hid=int(fields["hid"]), table=_slice(fields, dev),
                    thresholds=to_device(fields["thresholds"],
                                         torch.float32, dev),
                    n_bins=int(fields["n_bins"]))


@dataclasses.dataclass
class PackedEnsemble:
    guest: GuestHalf
    hosts: list

    @classmethod
    def from_numpy(cls, guest: dict, hosts: list,
                   device="cuda") -> "PackedEnsemble":
        """Carry a packed ensemble across from numpy: ``guest`` and each
        entry of ``hosts`` hold the fields of the JAX package's halves,
        laid out as its export payloads are (``_guest_payload`` /
        ``_host_payload``: the manifest values and the arrays in one
        dict).  ``load_ensemble`` goes through here too."""
        return cls(guest=guest_half_from_numpy(guest, device),
                   hosts=[host_half_from_numpy(h, device) for h in hosts])
