"""Per-party model export/import for the port's serving path.

The on-disk format is the JAX package's, unchanged, so an export made by
either package loads in the other:

    <out_dir>/
      guest/   manifest.json  arrays.npz   (structure, leaf weights,
                                            guest splits, guest binning)
      host0/   manifest.json  arrays.npz   (host0 splits + binning ONLY)
      host1/   ...

Each party directory is self-contained and written to a temp dir, then
published with an atomic rename.  Manifests carry array shapes/dtypes so
corruption fails loudly (``ValueError``) instead of mis-serving, and the
export audit refuses any undeclared array or secret field name.  Loading
reads numpy fields and builds device tensors through
:meth:`PackedEnsemble.from_numpy`.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from ..analysis.registry import SECRET_FIELD_NAMES
from .packed import (GuestHalf, HostHalf, PackedEnsemble,
                     guest_half_from_numpy, host_half_from_numpy)

FORMAT = "sbt-packed-serving"
VERSION = 1

_GUEST_ARRAYS = ("step", "roots", "tree_class", "leaf_w", "k_parties",
                 "fid", "bid", "thresholds")
_HOST_ARRAYS = ("fid", "bid", "thresholds")


def _manifest_keys(obj) -> set:
    keys = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            keys.add(k)
            keys |= _manifest_keys(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            keys |= _manifest_keys(v)
    return keys


def _audit_party(manifest: dict, arrays: dict) -> None:
    """At-rest half of the privacy boundary, checked at export time.

    A per-party export may carry ONLY its role's declared arrays — a
    guest half never ships host split content beyond its own slice, a
    host half never ships guest structure/leaf weights — and no field
    name anywhere (arrays or nested manifest keys) may collide with the
    declared secret registry (plaintext g/h, labels, private-key
    attributes)."""
    role = manifest.get("role")
    allowed = {"guest": _GUEST_ARRAYS, "host": _HOST_ARRAYS}.get(role)
    if allowed is None:
        raise ValueError(f"export audit: unknown party role {role!r}")
    extra = set(arrays) - set(allowed)
    if extra:
        raise ValueError(f"export audit: {role} half carries undeclared "
                         f"arrays {sorted(extra)}")
    leaked = (set(arrays) | _manifest_keys(manifest)) & SECRET_FIELD_NAMES
    if leaked:
        raise ValueError(f"export audit: {role} half carries secret field "
                         f"name(s) {sorted(leaked)}")


def _write_party(party_dir: str, manifest: dict, arrays: dict) -> None:
    os.makedirs(party_dir, exist_ok=True)
    manifest = dict(manifest, format=FORMAT, version=VERSION,
                    arrays={k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                            for k, v in arrays.items()})
    _audit_party(manifest, arrays)
    np.savez_compressed(os.path.join(party_dir, "arrays.npz"), **arrays)
    with open(os.path.join(party_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _guest_payload(g: GuestHalf) -> tuple:
    init = (g.init_score if np.isscalar(g.init_score)
            else np.asarray(g.init_score, np.float64).tolist())
    return ({"role": "guest", "objective": g.objective,
             "n_classes": g.n_classes, "n_bins": g.n_bins, "depth": g.depth,
             "n_trees": g.n_trees, "n_nodes": g.n_nodes,
             "n_hosts": g.n_hosts, "init_score": init},
            {"step": _np(g.step), "roots": _np(g.roots),
             "tree_class": _np(g.tree_class), "leaf_w": _np(g.leaf_w),
             "k_parties": _np(g.k_parties), "fid": _np(g.guest.fid),
             "bid": _np(g.guest.bid), "thresholds": _np(g.thresholds)})


def _host_payload(h: HostHalf) -> tuple:
    return ({"role": "host", "hid": h.hid, "n_bins": h.n_bins,
             "k": h.table.k},
            {"fid": _np(h.table.fid), "bid": _np(h.table.bid),
             "thresholds": _np(h.thresholds)})


def _publish(tmp: str, out_dir: str) -> str:
    # publish by rename: the previous export (if any) is moved aside
    # BEFORE the new one lands and deleted only after — a crash at any
    # point leaves either the old or the new export recoverable on disk,
    # never neither
    stale = out_dir + ".stale-export"
    if os.path.exists(stale):
        shutil.rmtree(stale)
    if os.path.exists(out_dir):
        os.replace(out_dir, stale)
    os.replace(tmp, out_dir)                 # atomic publish
    if os.path.exists(stale):
        shutil.rmtree(stale)
    return out_dir


def _fresh_tmp(out_dir: str) -> tuple:
    out_dir = out_dir.rstrip("/")
    tmp = out_dir + ".tmp-export"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    return out_dir, tmp


def export_guest(guest: GuestHalf, out_dir: str) -> str:
    """Atomically write ONE party directory: the guest half."""
    out_dir, tmp = _fresh_tmp(out_dir)
    _write_party(tmp, *_guest_payload(guest))
    return _publish(tmp, out_dir)


def export_host(host: HostHalf, out_dir: str) -> str:
    """Atomically write ONE party directory: a host half (its split table
    + binning thresholds only)."""
    out_dir, tmp = _fresh_tmp(out_dir)
    _write_party(tmp, *_host_payload(host))
    return _publish(tmp, out_dir)


def export_model(ensemble: PackedEnsemble, out_dir: str) -> str:
    """Write every party's serving half of a ``PackedEnsemble``; returns
    ``out_dir``.  The whole export lands atomically: a partial write can
    never shadow a previous good export."""
    if not isinstance(ensemble, PackedEnsemble):
        raise TypeError(f"export_model takes a PackedEnsemble, got "
                        f"{type(ensemble).__name__}")
    out_dir, tmp = _fresh_tmp(out_dir)
    _write_party(os.path.join(tmp, "guest"), *_guest_payload(ensemble.guest))
    for h in ensemble.hosts:
        _write_party(os.path.join(tmp, f"host{h.hid}"), *_host_payload(h))
    return _publish(tmp, out_dir)


def _read_party(party_dir: str, role: str, names: tuple) -> tuple:
    """Validated (manifest, arrays) for one party dir; ValueError on any
    corruption (bad JSON, wrong role/format, missing or mis-shaped
    arrays)."""
    mpath = os.path.join(party_dir, "manifest.json")
    try:
        with open(mpath) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"corrupt serving manifest {mpath}: {e}") from e
    if man.get("format") != FORMAT:
        raise ValueError(f"{mpath}: not a {FORMAT} manifest "
                         f"(format={man.get('format')!r})")
    if man.get("role") != role:
        raise ValueError(f"{mpath}: role {man.get('role')!r}, "
                         f"expected {role!r}")
    meta = man.get("arrays")
    if not isinstance(meta, dict):
        raise ValueError(f"{mpath}: missing arrays metadata")
    apath = os.path.join(party_dir, "arrays.npz")
    try:
        z = np.load(apath)
    except Exception as e:   # truncated/corrupt zip, missing file, ...
        raise ValueError(f"corrupt serving arrays {apath}: {e}") from e
    with z:
        arrays = {}
        for name in names:
            if name not in meta or name not in z:
                raise ValueError(f"{mpath}: missing array {name!r}")
            arr = z[name]
            if list(arr.shape) != list(meta[name]["shape"]):
                raise ValueError(
                    f"{mpath}: array {name!r} shape {list(arr.shape)} != "
                    f"manifest {meta[name]['shape']}")
            if str(arr.dtype) != meta[name]["dtype"]:
                raise ValueError(
                    f"{mpath}: array {name!r} dtype {arr.dtype} != "
                    f"manifest {meta[name]['dtype']}")
            arrays[name] = arr
    return man, arrays


_GUEST_VALUES = ("depth", "n_bins", "objective", "n_classes", "init_score")
_HOST_VALUES = ("hid", "n_bins")


def _party_fields(party_dir: str, role: str, names: tuple,
                  values: tuple) -> tuple:
    man, arrays = _read_party(party_dir, role, names)
    try:
        return man, dict(arrays, **{k: man[k] for k in values})
    except KeyError as e:
        raise ValueError(f"corrupt {role} manifest: missing {e}") from e


def _guest_fields(party_dir: str) -> dict:
    """The guest's numpy fields, in the layout ``from_numpy`` takes."""
    man, fields = _party_fields(party_dir, "guest", _GUEST_ARRAYS,
                                _GUEST_VALUES)
    try:
        n_trees, n_nodes = int(man["n_trees"]), int(man["n_nodes"])
    except KeyError as e:
        raise ValueError(f"corrupt guest manifest: missing {e}") from e
    if (fields["roots"].shape[0] != n_trees
            or fields["step"].shape[0] != n_nodes):
        raise ValueError("guest manifest tree/node counts disagree with "
                         "arrays")
    return fields


def _host_fields(party_dir: str) -> dict:
    return _party_fields(party_dir, "host", _HOST_ARRAYS, _HOST_VALUES)[1]


def load_guest(party_dir: str, device="cuda") -> GuestHalf:
    return guest_half_from_numpy(_guest_fields(party_dir), device)


def load_host(party_dir: str, device="cuda") -> HostHalf:
    return host_half_from_numpy(_host_fields(party_dir), device)


def load_ensemble(out_dir: str, device="cuda") -> PackedEnsemble:
    """Load every party half onto ``device`` as a ``PackedEnsemble``
    (simulation convenience; real deployments load one half per
    process)."""
    guest = _guest_fields(os.path.join(out_dir, "guest"))
    n_hosts = int(guest["k_parties"].shape[0]) - 1
    hosts = [_host_fields(os.path.join(out_dir, f"host{h}"))
             for h in range(n_hosts)]
    return PackedEnsemble.from_numpy(guest, hosts, device)
