"""Device ms a step in the ``coded.update`` span (``launch/steps.py``
``_finish``): the clip, the global norm, the schedule and the
optimizer's update in place."""


def read(rec):
    t = rec.get("trace")
    key = "span.coded.update.device_ms"
    if not t or key not in t.get("launches", {}):
        return None
    return t["launches"][key] / t["steps"]
