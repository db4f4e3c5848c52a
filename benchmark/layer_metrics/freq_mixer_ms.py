"""Device milliseconds a batch of SEMamba's frequency-axis Mamba mixers:
the operations launched inside the program's ``adt.sm.freq_mixer`` spans
(in_proj to out_proj, both directions) over the traced sub-window
(``benchmark.spans``), per profiled batch. None where the program has no
such span."""

PHASE = "sm.freq_mixer"


def read(record):
    t = record.get("device_trace") or {}
    program = t.get("program")
    if not program or PHASE not in program["phases"]:
        return None
    return 1e3 * program["device_s"][PHASE] / t["iters"]
