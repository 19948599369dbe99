"""Host ms of the bulk prefill and its handoff into the decode cache per
1000 prompt tokens, synchronized at both ends, over one batch of each of
the mix's lengths weighted by its share of the cycle."""
import collections


def read(rec):
    split = rec.get("split")
    if not split:
        return None
    share = collections.Counter(rec["traffic"]["cycle"])
    B = rec["traffic"]["batch"]
    ms = sum(share[L] * s["prefill_s"] * 1e3 for L, s in split.items())
    ktok = sum(share[L] * B * L / 1e3 for L in split)
    return ms / ktok
