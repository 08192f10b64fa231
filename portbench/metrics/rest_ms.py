"""``rest_ms.*``: device milliseconds a step in kernels that are neither
matrix products nor attention (``trace.KERNEL_GROUPS``; copies and fills
left out), over the traced steps."""


def read(name, rec):
    trace = rec.get("trace")
    if trace is None or not rec.get("steps"):
        return None
    rest = trace.group_s().get("rest")
    return None if rest is None else 1e3 * rest / rec["steps"]
