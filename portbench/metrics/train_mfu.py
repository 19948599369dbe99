"""The coded step's model FLOPs utilization, %: forward and backward
FLOPs of every (edge, worker) group's rows (``work.train_step_flops``:
matmuls with the head, causal attention pairs, ``top_k`` experts, no
recompute) of the window's steps, over the window at the card's bf16
peak."""
from portbench import work


def read(rec):
    if not rec.get("steps"):
        return None
    return 100.0 * rec["flops"] / (rec["window_s"]
                                   * work.PEAK_FLOPS["bfloat16"])
