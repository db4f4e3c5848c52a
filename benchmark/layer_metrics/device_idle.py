"""The share of the traced sub-window in which no operation ran on the
device (profiler trace)."""


def read(record):
    t = record.get("device_trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * max(0.0, 1.0 - t["busy_s"] / t["window_s"])
