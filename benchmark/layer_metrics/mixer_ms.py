"""Milliseconds of one ``sample_audio`` call of the on-device mixer at the
cell's batch, by CUDA events over several calls."""


def read(record):
    s = record.get("mixer_s")
    return None if not s else 1e3 * s
