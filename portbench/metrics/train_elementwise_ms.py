"""Device ms a step in PyTorch's elementwise, copy and reduce kernels,
by name, whatever launched them: attention's float32 recompute backward,
the stacked layer leaves' select backward, the model's norms, rotary and
activations, the coded decode's accumulation, the hop's error feedback
and quantization, the clip and AdamW's float32 passes."""
from portbench import profiling


def read(rec):
    t = rec.get("trace")
    if not t or not t["device"]:
        return None
    return profiling.kernel_ms(t["device"], profiling.is_elementwise) \
        / t["steps"]
