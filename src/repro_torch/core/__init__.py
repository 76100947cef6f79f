"""Core pieces of the port that its serving path needs: binning, the
wire ledger and counters, and the loss links."""
