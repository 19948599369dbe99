"""Serving's model FLOPs utilization, %: the prefill and decode FLOPs of
the window's batches (``work.prefill_flops``, ``work.decode_flops``)
over the window at the card's bf16 peak."""
from portbench import work


def read(rec):
    if not rec.get("batches"):
        return None
    return 100.0 * rec["flops"] / (rec["window_s"]
                                   * work.PEAK_FLOPS["bfloat16"])
