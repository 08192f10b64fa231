"""``dispatch_ms.*``: host milliseconds a step to enqueue its work: a
train step's ``step`` span, a request's ``eval`` span less its ``fetch``
(the wait for the answer); the spanned pass (``spans.py``), whose table
sets it against the device's busy milliseconds a step."""

from portbench import spans


def read(name, rec):
    s = spans.of(rec)
    if s is None:
        return None
    host = s["host_ms"]
    if s["kind"] == "train" and s["calls"]["step"]:
        return host["step"]
    if s["kind"] == "score" and s["calls"]["eval"]:
        return host["eval"] - host["fetch"]
    return None
