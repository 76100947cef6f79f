"""Federated serving on PyTorch: packed ensembles held as device tensors,
the round-batched bit protocol (one round-trip per host per batch), and
the per-party export format shared with the JAX package."""

from .engine import FederatedPredictor, PartyBits  # noqa: F401
from .export import (export_guest, export_host, export_model,  # noqa: F401
                     load_ensemble, load_guest, load_host)
from .packed import (GuestHalf, HostHalf, PackedEnsemble,  # noqa: F401
                     PartySlice, guest_half_from_numpy, host_half_from_numpy)
