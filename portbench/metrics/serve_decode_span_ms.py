"""Ms a decode step in the ``serving.decode`` spans (``api/serving.py``
``token_loop``: one decode step and the greedy pick), over the spans'
own count: the stream time between each span's two events.  The decode
is host-paced, so this is the pace at which the host, slowed by the
profiler, launches a step, not the card's work in it (the card is idle
between the launches)."""


def read(rec):
    t = rec.get("trace")
    got = t.get("launches", {}) if t else {}
    key = "span.serving.decode.device_ms"
    if key not in got or not got.get("span.serving.decode.n"):
        return None
    return got[key] / got["span.serving.decode.n"]
