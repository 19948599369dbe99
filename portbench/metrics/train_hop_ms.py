"""Device ms a step in the ``coded.hop`` spans (``dist/grad_sync.py``
``compressed_coded_psum``): each pod's error feedback, quantization and
gather, and the dequantizing combine over the pods (eq. 27)."""


def read(rec):
    t = rec.get("trace")
    key = "span.coded.hop.device_ms"
    if not t or key not in t.get("launches", {}):
        return None
    return t["launches"][key] / t["steps"]
