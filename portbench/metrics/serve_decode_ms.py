"""Host ms a decode step of the generation loop (the greedy token, one
decode step, its attention over the cache), over one batch of each of
the mix's lengths weighted by its share of the cycle."""
import collections


def read(rec):
    split = rec.get("split")
    if not split:
        return None
    share = collections.Counter(rec["traffic"]["cycle"])
    G = rec["traffic"]["gen"]
    ms = sum(share[L] * s["decode_s"] * 1e3 / G for L, s in split.items())
    return ms / sum(share[L] for L in split)
