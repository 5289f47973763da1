"""Collocation data: the cavity dataset and its point samplers."""
