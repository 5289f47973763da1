"""Device ms a step of every operation in the traced chunk but the port's
own kernels (the loss kernels 1+2, the streams kernels 3-6): the plain
PyTorch part (EVM net, boundary loss, residual glue, Adam), its copies and
fills, and the kernels' small helpers (weight split, partial sums)."""

from benchmark.metrics._loss_kernels import PORT_KERNELS


def read(rec):
    if not rec["device"]:
        return None
    us = sum(dur for name, _, _, dur in rec["device"]
             if not any(k in name for k in PORT_KERNELS))
    return us / 1e3 / rec["steps"]
