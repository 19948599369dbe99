"""Device ms of the ``serving.prefill`` span (``api/serving.py``
``make_prefill_fn``'s bulk path: ``tf.prefill``) per 1000 prompt tokens
of the profiled batches, on the path the window runs."""


def read(rec):
    t = rec.get("trace")
    key = "span.serving.prefill.device_ms"
    if not t or key not in t.get("launches", {}):
        return None
    ktok = rec["traffic"]["batch"] * t["length"] * t["steps"] / 1e3
    return t["launches"][key] / ktok
