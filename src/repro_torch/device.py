"""Device selection shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    ``"cuda"`` (the default everywhere) needs a card: without one this
    raises instead of carrying on quietly on the CPU.  ``"cpu"`` runs the
    kernels' plain versions and is what the CPU tests ask for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            # one canonical name, so cached tensors compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def to_device(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (a numpy array, a list or a tensor) as a ``dtype`` tensor on
    ``device``; a tensor already there is returned as it is, and a numpy
    array lands row-major whatever its own order."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                           device=device)
