"""``score_ms.*``: host milliseconds in ``score_pairs`` (its probabilities
on the host) a round, over the window's rounds."""


def read(name, rec):
    if not rec.get("rounds"):
        return None
    return 1e3 * rec["score_s"] / rec["rounds"]
