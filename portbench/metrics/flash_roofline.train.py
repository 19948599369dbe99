"""The flash kernel's share of its roofline in the coded step, %: the
bound of every launch in the profiled steps (``work.flash_work`` at a
group's rows, causal, with the log-sum-exp) over the kernel's device
time.  Silent unless the launch counter, the trace's records and the
step's shape agree on the launches."""
from portbench import profiling, work


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    m, tr = rec["model"], rec["traffic"]
    groups = tr["cluster"]["n_edges"] * tr["cluster"]["n_workers"]
    S = tr["seq_len"]
    nbytes, flops = work.flash_work(
        rec["computed_rows"] // groups, S, S, m["n_heads"], m["n_kv_heads"],
        m["head_dim"], work.causal_pairs(S), elem=2, with_lse=True)
    per_launch, _ = work.bound_ms(nbytes, flops, "bfloat16")
    return profiling.roofline_pct(t, "flash_attention", profiling.is_flash,
                                  [per_launch] * t["launches"].get(
                                      "flash_attention", 0))
