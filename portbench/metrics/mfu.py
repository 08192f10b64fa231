"""``mfu.*``: the model FLOP of the run's window (the job's hand count,
``flops.py``, of all the work it completed) over the window's length on
the host clock, as a share of the bf16 peak; nothing where the traced run
saw the device run nothing (a CPU run)."""

from portbench.flops import PEAK_BF16_FLOPS


def read(name, rec):
    trace = rec.get("trace")
    if not rec.get("model_flop") or trace is None or trace.busy_s <= 0.0:
        return None
    return 100.0 * rec["model_flop"] / rec["window_s"] / PEAK_BF16_FLOPS
