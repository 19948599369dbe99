"""Device ms a step in the ``model.backward`` spans (``launch/steps.py``
``_grads``): every group's backward, with each rematerialized layer's
recomputed forward, the stacked leaves' select backward and attention's
backward."""


def read(rec):
    t = rec.get("trace")
    key = "span.model.backward.device_ms"
    if not t or key not in t.get("launches", {}):
        return None
    return t["launches"][key] / t["steps"]
