"""The Mamba mixers' conv and scan kernels' share of their byte bound: x and
z in and y out of every mixer of one batch of the cell
(``benchmark.sm_counts.ssm_bytes``) at the card's HBM bandwidth, over the
profiler's device time, a batch, of the kernels named ``ssm_*kernel`` in
the traced sub-window. None where no such kernel ran."""

import re

from benchmark.devtrace import kernel_roofline

SSM = re.compile(r"ssm_\w*kernel")


def read(record):
    return kernel_roofline(record, "ssm", SSM)
