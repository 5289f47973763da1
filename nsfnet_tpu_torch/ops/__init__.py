"""Derivative engine, residuals, losses and the three hand-written kernel pairs."""
