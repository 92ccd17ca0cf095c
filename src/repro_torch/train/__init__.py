"""Training: functional optimizers and the out-of-core GCN train loop."""
from repro_torch.train.optim import (
    OPTIMIZERS, adafactor_init, adafactor_update, adamw_init, adamw_update,
    make_optimizer,
)
from repro_torch.train.loop import gcn_train_loop, make_gcn_train_step

__all__ = [
    "adamw_init", "adamw_update", "adafactor_init", "adafactor_update",
    "OPTIMIZERS", "make_optimizer",
    "make_gcn_train_step", "gcn_train_loop",
]
