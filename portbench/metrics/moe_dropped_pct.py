"""The share of the (token, choice) entries that the MoE layers dropped
at their experts' capacity, %: ``count.moe.dropped`` over
``count.moe.routed`` (``models/moe.py`` ``moe_ffn``), every layer of
every group of the profiled steps."""


def read(rec):
    t = rec.get("trace")
    got = t.get("launches", {}) if t else {}
    if not got.get("count.moe.routed") or "count.moe.dropped" not in got:
        return None
    return 100.0 * got["count.moe.dropped"] / got["count.moe.routed"]
