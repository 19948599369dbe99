"""Device ms a batch of the ``serving.handoff`` span (``api/serving.py``
``make_prefill_fn``'s bulk path: ``tf.prefill_to_decode_cache``, the
prefill's cache laid into the decode ring buffers)."""


def read(rec):
    t = rec.get("trace")
    key = "span.serving.handoff.device_ms"
    if not t or key not in t.get("launches", {}):
        return None
    return t["launches"][key] / t["steps"]
