"""Kernel 2 (`loss_bwd_kernel`, the fused residual loss backward): its
one-pass roofline bound over its measured device time, in %. At "high" the
kernel runs three bf16 passes, so about 33% is its ceiling."""

from benchmark.metrics._loss_kernels import roofline_pct


def read(rec):
    return roofline_pct(rec, 2)
