"""The port stands alone: no JAX, nothing of the JAX package, and no
quiet run on the CPU.

* No file under ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or ``repro`` (an AST scan of every import statement).
* Every port module imports in a fresh interpreter where ``jax`` and
  ``repro`` cannot be imported at all.
* Each entry point, called without ``device="cpu"``, raises when no card
  is present; ``chip_smoke.py`` exits non-zero and prints no result.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import LocalGBDT, SBTParams, VerticalBoosting
from repro_torch.core.binning import BinnedData, apply_binning, bin_features
from repro_torch.core.he import get_cipher
from repro_torch.serving import (FederatedPredictor, PackedEnsemble,
                                 load_ensemble, load_guest, load_host,
                                 pack_guest)
from repro_torch.serving.export import _guest_fields, _host_fields

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "src", "repro_torch")
FIXTURE = os.path.join(PKG, "fixtures", "serving_t25_d6")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 35
    bad = {os.path.relpath(p, ROOT): sorted(set(_imported_roots(p))
                                            & set(FORBIDDEN))
           for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_every_port_module_imports_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 35


def _cpu_ensemble():
    return load_ensemble(FIXTURE, device="cpu")


ENTRY_POINTS = {
    "load_ensemble": lambda: load_ensemble(FIXTURE),
    "load_guest": lambda: load_guest(os.path.join(FIXTURE, "guest")),
    "load_host": lambda: load_host(os.path.join(FIXTURE, "host0")),
    "from_numpy": lambda: PackedEnsemble.from_numpy(
        _guest_fields(os.path.join(FIXTURE, "guest")),
        [_host_fields(os.path.join(FIXTURE, "host0"))]),
    "FederatedPredictor": lambda: FederatedPredictor(
        _cpu_ensemble().guest, _cpu_ensemble().hosts),
    "apply_binning": lambda: apply_binning(
        np.zeros((4, 2), np.float32),
        BinnedData(bins=torch.zeros((0, 2), dtype=torch.int32),
                   thresholds=np.zeros((2, 3), np.float32), n_bins=4)),
    "bin_features": lambda: bin_features(np.zeros((4, 2), np.float32), 4),
    "VerticalBoosting": lambda: VerticalBoosting(SBTParams()),
    "LocalGBDT": lambda: LocalGBDT(SBTParams()),
    "PackedEnsemble.from_model": lambda: PackedEnsemble.from_model(
        _cpu_model()),
    "pack_guest": lambda: pack_guest(_cpu_model()),
    "PlainCipher.encrypt_ints": lambda: get_cipher(
        "plain", bits=64).encrypt_ints([1, 2]),
    "PlainCipher.zero": lambda: get_cipher("plain", bits=64).zero((2,)),
    "AffineCipher.zero": lambda: get_cipher("affine", key_bits=64,
                                            seed=0).zero((2,)),
}


def _cpu_model():
    X = np.random.default_rng(0).normal(0, 1, (64, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    return VerticalBoosting(SBTParams(n_trees=1, max_depth=2, n_bins=8,
                                      device="cpu")).fit(X[:, :2], y,
                                                         [X[:, 2:]])


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_refuse_to_run_quietly_on_cpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr
