"""PyTorch/CUDA port of the SecureBoost+ system, beside the JAX package.

The port imports ``torch`` and numpy and nothing of the JAX package.  Its
entry points take ``device=`` (default ``"cuda"``) and raise when no card
is present unless the caller asks for ``device="cpu"``.  Hand-written
CUDA kernels live in ``csrc/`` and are built on first use
(``kernels/build.py``).
"""

from .device import resolve_device  # noqa: F401
