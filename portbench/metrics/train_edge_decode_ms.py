"""Device ms a step in the ``coded.edge_decode`` spans (``dist/mesh.py``
``psum_data``): each group's gradient scaled by its λ and folded into
its pod's partial (eq. 25)."""


def read(rec):
    t = rec.get("trace")
    key = "span.coded.edge_decode.device_ms"
    if not t or key not in t.get("launches", {}):
        return None
    return t["launches"][key] / t["steps"]
