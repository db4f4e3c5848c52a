"""K2's share of its byte bound: the complex64 spectrum in and the float32
audio out of one batch of the cell (``benchmark.counts``) at the card's
HBM bandwidth, over the profiler's device time, a batch, of the iSTFT
kernels (``istft_*kernel``) in the traced sub-window."""

import re

from benchmark.devtrace import kernel_roofline

K2 = re.compile(r"(?<![A-Za-z])istft_\w*kernel")


def read(record):
    return kernel_roofline(record, "istft", K2)
