"""Device ms a step in the sort, gather, scatter and index kernels, by
name: the expert layer's routing sort and dispatch, and any other
indexing in the step (the embedding's lookup, the loss's gather)."""
from portbench import profiling


def read(rec):
    t = rec.get("trace")
    if not t or not t["device"] or not rec["model"].get("n_experts"):
        return None
    return profiling.kernel_ms(t["device"], profiling.is_dispatch) \
        / t["steps"]
