from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    SGDState,
    adamw,
    apply_updates,
    fedprox_penalty,
    sgd,
)

__all__ = ["AdamState", "Optimizer", "SGDState", "adamw", "apply_updates",
           "fedprox_penalty", "sgd"]
