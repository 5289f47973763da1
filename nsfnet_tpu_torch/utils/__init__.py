"""Utilities of the port (its own copies; nothing of nsfnet_tpu)."""
