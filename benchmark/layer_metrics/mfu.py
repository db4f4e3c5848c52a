"""The whole step's share of the card's bf16 peak over the window: the
U-Net FLOPs of all the work completed (every clip served, or 3x the
forward of every training sample; ``benchmark.counts``) over the window's
wall seconds."""

from benchmark.counts import PEAK_BF16_FLOPS


def read(record):
    c = record["counters"]
    if not c.get("flops") or not c.get("window_s"):
        return None
    return 100.0 * c["flops"] / c["window_s"] / PEAK_BF16_FLOPS
