"""The port's copies of the privacy and wire-protocol declarations that
its serving path uses (the static analyzer itself is not ported)."""
