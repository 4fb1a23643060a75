"""Point-cloud ops and the hand-written kernels behind them."""
