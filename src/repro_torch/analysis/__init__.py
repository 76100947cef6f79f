"""The port's copies of the privacy and wire-protocol declarations that
its training and serving paths use (the static analyzer itself is not
ported)."""
