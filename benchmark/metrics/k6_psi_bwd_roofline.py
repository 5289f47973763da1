"""Kernel 6 (`psi_bwd_kernel`, the streamfunction's 13-stream backward): its
one-pass roofline bound over its measured device time, in %. At "high" the
kernel runs three bf16 passes, so about 33% is its ceiling."""

from benchmark.metrics._loss_kernels import streams_roofline_pct


def read(rec):
    return streams_roofline_pct(rec, "psi_bwd_kernel")
