"""Device ms a step of every operation in the traced chunk but kernels 1 and
2: the plain PyTorch part (EVM net, boundary loss, residual glue, Adam) and
its copies and fills."""

from benchmark.metrics._loss_kernels import K1, K2


def read(rec):
    if not rec["device"]:
        return None
    us = sum(dur for name, _, _, dur in rec["device"] if K1 not in name and K2 not in name)
    return us / 1e3 / rec["steps"]
