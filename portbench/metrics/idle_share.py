"""``idle_share.*``: the share of the traced window in which no operation
ran on the device (the union of their intervals, not their sum)."""


def read(name, rec):
    trace = rec.get("trace")
    if trace is None or trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
