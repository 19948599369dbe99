"""The decode kernel's share of its roofline, %: every layer's launch at
every decode step of the profiled batch, each reading the cache slots up
to its position (``work.decode_work``), over the kernel's device time."""
from portbench import profiling, work


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    m, tr, L = rec["model"], rec["traffic"], t["length"]
    bounds = []
    for q_pos in range(L, L + tr["gen"]):
        nbytes, flops = work.decode_work(tr["batch"], m["n_heads"],
                                         m["n_kv_heads"], m["head_dim"],
                                         q_pos + 1)
        bounds += [work.bound_ms(nbytes, flops, "bfloat16")[0]] \
            * m["n_layers"]
    return profiling.roofline_pct(t, "decode_attention", profiling.is_decode,
                                  bounds * t["steps"])
