"""``module_ms.<cell>.<span>``: device milliseconds a step in every
operation launched inside the program's module span ``<span>`` or charged
to it (a backward node's, to the span of its forward operation);
``unspanned``: the ``rest``-group kernels charged to no span (the
attributed pass, ``spans.py``)."""

from portbench import spans


def read(name, rec):
    s = spans.of(rec)
    if s is None or s["module_ms"] is None:
        return None
    return s["module_ms"].get(name.split(".")[2], 0.0)
