"""The optimizers and learning-rate schedules of the port."""
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine_with_warmup,
    exponential_decay,
    make_schedule,
)
from repro_torch.optim.sgd import (  # noqa: F401
    Optimizer,
    adamw,
    clip_by_global_norm,
    make_optimizer,
    momentum,
    sgd,
)
