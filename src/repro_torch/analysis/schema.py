"""Wire-protocol tags the port ships under.

The same tag strings as the JAX package's schema registry, so the
per-tag ``Channel`` ledgers of the two packages compare equal.  Only the
training and serving tags are kept here; the transport's control tags
come with the slice that ports it.
"""

from __future__ import annotations

ENC_GH = "enc_gh"               # encrypted g/h broadcast (tree boundary)
ASSIGN_SYNC = "assign_sync"     # one layer plan per host
SPLIT_INFOS = "split_infos"     # one candidate stack reply per host
CHOSEN_SID = "chosen_sid"       # the committed split id + instance space
ASSIGN_MASK = "assign_mask"     # host's go-left bitmask reply
PREDICT_REQ = "predict_req"     # serving: instance ids for one batch
PREDICT_BITS = "predict_bits"   # serving: packed decision bits reply
