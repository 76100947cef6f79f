"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Every ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes) for Hopper's ``sm_90a`` target:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The library is named after a hash of its source, the shared headers and the
flags, and lands in ``_build/`` next to ``csrc/`` (listed in
``.gitignore``), so an edited source is rebuilt and an unchanged one is
not.  :func:`build` compiles one source if it is not built yet;
:func:`load` builds what it needs and returns the loaded library.  A
wrapper declares each C entry's ``argtypes`` (``c_void_p`` for pointers and
the stream), and each entry returns ``cudaGetLastError()``, which the
wrapper turns into an exception when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc`` (default
    ``/usr/local/cuda``)."""
    return shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def sources() -> list:
    """Names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns what
    the compiler printed (ptxas' registers, shared memory and spills; empty
    when nothing was built) and raises with it if the compile fails."""
    out = lib_path(name)
    if out.is_file():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)                    # atomic: never a half-written .so
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
    return lib
