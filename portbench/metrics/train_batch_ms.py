"""Device ms a step in the ``coded.batch`` span (``api/session.py``
``_execute``): the coded batch built from the part streams, its copy to
the card and the λ operand.  On the card's clock (CUDA events), so it
is the time the card waits for the host's batch once it has drained."""


def read(rec):
    t = rec.get("trace")
    key = "span.coded.batch.device_ms"
    if not t or key not in t.get("launches", {}):
        return None
    return t["launches"][key] / t["steps"]
