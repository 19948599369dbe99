from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    clip_by_global_norm_,
    cosine_schedule,
    global_norm,
    make_optimizer,
    momentum,
    sgd,
)
