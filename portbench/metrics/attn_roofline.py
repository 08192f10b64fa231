"""``attn_roofline.*``: the attention entry's least time at the cell's
shapes and masks (``flops.attention_bound_s``) over its device time a call
(``port.attention_seconds``), as a share."""


def read(name, rec):
    if not rec.get("attn_s"):
        return None
    return 100.0 * rec["attn_bound_s"] / rec["attn_s"]
