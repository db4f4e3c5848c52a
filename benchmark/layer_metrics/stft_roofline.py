"""K1's share of its byte bound: the float32 audio in and the complex64
spectrum out of one batch of the cell (``benchmark.counts``) at the card's
HBM bandwidth, over the profiler's device time, a batch, of the STFT
kernels (``stft_*kernel``, not ``istft_``) in the traced sub-window."""

import re

from benchmark.devtrace import kernel_roofline

K1 = re.compile(r"(?<![A-Za-z])stft_\w*kernel")


def read(record):
    return kernel_roofline(record, "stft", K1)
