"""Drivers: how a traffic mix drives the port, one module each, named by the
traffic file's `driver` key. Each has `run(ctx) -> dict` (see run.py)."""
