"""Device ms a step in the ``model.forward`` spans (``launch/steps.py``
``_grads``): every (edge, worker) group's forward through the loss, its
MoE layers included."""


def read(rec):
    t = rec.get("trace")
    key = "span.model.forward.device_ms"
    if not t or key not in t.get("launches", {}):
        return None
    return t["launches"][key] / t["steps"]
