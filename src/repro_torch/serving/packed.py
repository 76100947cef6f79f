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
package, and a model the port trained (:meth:`PackedEnsemble.from_model`),
load through one code path.  Nothing here is row-level: a packed model is
a pure function of the trees.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.tree import GUEST
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

    @classmethod
    def from_model(cls, model, device="cuda") -> "PackedEnsemble":
        """Flatten a trained ``VerticalBoosting`` (in-process hosts) into
        serving halves on ``device``, through :meth:`from_numpy`."""
        guest, host_keys = _guest_fields(model)
        trees = model.trees
        hosts = [_host_fields(h, keys, [t.host_tables[h] for t in trees],
                              model.host_data[h].thresholds,
                              model.params.n_bins)
                 for h, keys in enumerate(host_keys)]
        return cls.from_numpy(guest, hosts, device)


def _guest_fields(model) -> tuple:
    """The guest half's numpy fields (the layout :meth:`from_numpy` and
    the export format take), and per host its internal nodes in bit-column
    order as ``(tree_idx, nid)`` pairs; host split content is not read."""
    trees = model.trees
    if not trees:
        raise ValueError("cannot pack an unfitted model (no trees)")
    n_hosts = len(model.host_data)
    for t in trees:
        # the grower keeps row->leaf maps train-side; a tree that still
        # carries one must never reach an exportable ensemble
        if hasattr(t, "leaf_rows"):
            raise AssertionError(
                "FederatedTree retains row-level training state "
                "(leaf_rows); packed models must be training-set free")

    arrays = [t.node_arrays() for t in trees]

    # pass 1: bit-column ids -- guest block, then host blocks (hid
    # order), each ordered by (tree, nid)
    owners = [GUEST] + list(range(n_hosts))
    internal = {p: [] for p in owners}
    n_leaves = 0
    for ti, a in enumerate(arrays):
        for nid in range(len(a["party"])):
            if a["left"][nid] != -1:
                internal[int(a["party"][nid])].append((ti, nid))
            else:
                n_leaves += 1
    k_parties = np.asarray([len(internal[p]) for p in owners], np.int32)
    n_nodes = int(k_parties.sum()) + n_leaves

    gid = {}
    col = 0
    for p in owners:
        for key in internal[p]:
            gid[key] = col
            col += 1
    for ti, a in enumerate(arrays):
        for nid in range(len(a["party"])):
            if a["left"][nid] == -1:
                gid[(ti, nid)] = col
                col += 1

    w_dim = arrays[0]["weight"].shape[1]
    step = np.empty((n_nodes, 2), np.int32)
    leaf_w = np.zeros((n_nodes, w_dim), np.float64)
    depth = 0
    roots = np.empty(len(trees), np.int32)
    for ti, a in enumerate(arrays):
        roots[ti] = gid[(ti, 0)]
        depth = max(depth, int(a["depth"].max()))
        for nid in range(len(a["party"])):
            g = gid[(ti, nid)]
            if a["left"][nid] != -1:
                step[g, 0] = gid[(ti, int(a["right"][nid]))]
                step[g, 1] = gid[(ti, int(a["left"][nid]))]
            else:
                step[g] = g
                leaf_w[g] = a["weight"][nid]

    fid = np.empty(len(internal[GUEST]), np.int32)
    bid = np.empty(len(internal[GUEST]), np.int32)
    for i, (ti, nid) in enumerate(internal[GUEST]):
        fid[i] = int(arrays[ti]["fid"][nid])
        bid[i] = int(arrays[ti]["bid"][nid])
    p = model.params
    fields = dict(
        step=step, roots=roots,
        tree_class=np.asarray(model.tree_class, np.int32),
        leaf_w=leaf_w, depth=depth, k_parties=k_parties, fid=fid, bid=bid,
        thresholds=np.asarray(model.guest_data.thresholds, np.float32),
        n_bins=p.n_bins, objective=p.objective, n_classes=p.n_classes,
        init_score=(np.asarray(model.init_score, np.float64)
                    if p.objective != "binary"
                    else float(model.init_score)))
    return fields, [internal[h] for h in range(n_hosts)]


def _host_fields(hid: int, keys: list, tables: list, thresholds,
                 n_bins: int) -> dict:
    """One host's numpy fields from the guest-published bit-column key
    order and the host's OWN per-tree (fid, bid) tables
    (``tables[tree_idx][nid]``)."""
    fid = np.empty(len(keys), np.int32)
    bid = np.empty(len(keys), np.int32)
    for i, (ti, nid) in enumerate(keys):
        fid[i], bid[i] = tables[int(ti)][int(nid)]
    return dict(hid=hid, n_bins=n_bins, fid=fid, bid=bid,
                thresholds=np.asarray(thresholds, np.float32))


def pack_guest(model, device="cuda") -> tuple:
    """Pack the guest's serving half on ``device`` from a trained model,
    WITHOUT touching host split content.  Returns ``(guest_half,
    host_keys)``: ``host_keys[hid]`` is that host's internal nodes in
    bit-column order as ``(tree_idx, nid)`` pairs, all a host needs to
    build its own half (:func:`host_half_from_keys`)."""
    fields, host_keys = _guest_fields(model)
    return guest_half_from_numpy(fields, device), host_keys


def host_half_from_keys(hid: int, keys: list, tables: dict, thresholds,
                        n_bins: int, device="cuda") -> HostHalf:
    """Build one host's serving half on ``device`` from the
    guest-published key order and the host's own per-tree (fid, bid)
    tables (``tables[tree_idx][nid]``): the split content stays with the
    host."""
    return host_half_from_numpy(
        _host_fields(hid, keys, tables, thresholds, n_bins), device)
