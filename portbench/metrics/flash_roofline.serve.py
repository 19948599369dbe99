"""The flash kernel's share of its roofline in serving's bulk prefill,
%: one launch a layer at the profiled batch's prompt length
(``work.flash_work``, causal, no log-sum-exp) over the kernel's device
time."""
from portbench import profiling, work


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    m, B, L = rec["model"], rec["traffic"]["batch"], t["length"]
    nbytes, flops = work.flash_work(B, L, L, m["n_heads"], m["n_kv_heads"],
                                    m["head_dim"], work.causal_pairs(L))
    per_launch, _ = work.bound_ms(nbytes, flops, "bfloat16")
    return profiling.roofline_pct(t, "flash_attention", profiling.is_flash,
                                  [per_launch] * m["n_layers"] * t["steps"])
