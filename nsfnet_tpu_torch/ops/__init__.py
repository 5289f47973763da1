"""Derivative engine, residuals, losses and the fused residual-loss kernel pair."""
