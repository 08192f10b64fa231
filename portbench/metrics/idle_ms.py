"""``idle_ms.<cell>.<phase>``: device idle milliseconds a step in the gaps
whose middle finds the host in entry span ``<phase>`` and in none of the
entry spans inside it (``build_cache`` outside ``encode``); the spanned
pass (``spans.py``), the rule of ``trace.Trace.idle_gaps``."""

from portbench import spans


def read(name, rec):
    s = spans.of(rec)
    if s is None or s["idle_ms"] is None:
        return None
    return s["idle_ms"].get(name.split(".")[2], 0.0)
