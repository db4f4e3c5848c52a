"""Device milliseconds a batch of MP-SENet's frequency attention: the operations
launched inside the program's ``adt.mp.freq_attention`` spans over the
traced sub-window (``benchmark.spans``), per profiled batch. None where
the program has no such span."""

PHASE = "mp.freq_attention"


def read(record):
    t = record.get("device_trace") or {}
    program = t.get("program")
    if not program or PHASE not in program["phases"]:
        return None
    return 1e3 * program["device_s"][PHASE] / t["iters"]
