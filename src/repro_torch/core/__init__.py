"""Core of the port: binning, the cipher suites, the histogram engines, the
tree grower and the boosting loop, with the wire ledger and counters."""

from .boosting import LocalGBDT, SBTParams, VerticalBoosting  # noqa: F401
