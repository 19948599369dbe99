"""``coded_combine_q``'s share of its roofline, %: the hop's int8
combine of every leaf in the profiled steps (``work.combine_work``: both
pods' payloads and scales read once, the f32 sum written once) over the
kernel's device time.  Silent unless one launch a leaf a step is what
the counter and the trace show."""
from portbench import profiling, work


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    tr = rec["traffic"]
    pods, block = tr["cluster"]["n_edges"], tr["grad_block"]
    bounds = []
    for numel in rec["leaf_sizes"].values():
        F = -(-numel // block) * block
        nbytes, flops = work.combine_work(1, pods, F, pods * F,
                                          n_scales=pods * F // block)
        bounds.append(work.bound_ms(nbytes, flops, "float32")[0])
    return profiling.roofline_pct(t, "coded_combine_q", profiling.is_combine,
                                  bounds * t["steps"])
