"""Wire-protocol tags the port's serving path ships under.

The same tag strings as the JAX package's schema registry, so the
per-tag ``Channel`` ledgers of the two packages compare equal.  Only the
serving tags are kept here; the training and control tags come with the
slices that use them.
"""

from __future__ import annotations

PREDICT_REQ = "predict_req"     # serving: instance ids for one batch
PREDICT_BITS = "predict_bits"   # serving: packed decision bits reply
