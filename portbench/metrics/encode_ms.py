"""``encode_ms.*``: host milliseconds, synchronised, in ``build_cache`` a
round, over the window's rounds."""


def read(name, rec):
    if not rec.get("rounds"):
        return None
    return 1e3 * rec["encode_s"] / rec["rounds"]
