"""Device ms a step in the ``moe.experts`` spans (``models/moe.py``
``moe_ffn``: the three batched expert matmuls and the swiglu) and their
backward, every MoE layer of every group."""

SPANS = ("moe.experts",)


def read(rec):
    t = rec.get("trace")
    keys = [f"span.{s}{b}.device_ms" for s in SPANS for b in ("", ".bwd")]
    if not t or any(k not in t.get("launches", {}) for k in keys):
        return None
    return sum(t["launches"][k] for k in keys) / t["steps"]
