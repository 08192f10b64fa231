"""``stage_ms.*``: host milliseconds a step in the ``Trainer``'s
``stage`` span, the host batch stacked in pinned memory and its copy to
the card enqueued (the spanned pass, ``spans.py``)."""

from portbench import spans


def read(name, rec):
    s = spans.of(rec)
    if s is None or not s["calls"]["stage"]:
        return None
    return s["host_ms"]["stage"]
