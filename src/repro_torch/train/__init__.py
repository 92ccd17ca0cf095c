"""Training: functional optimizers, int8 error-feedback gradient
compression, the LM train step and loop, and the out-of-core GCN train
loop."""
from repro_torch.train.optim import (
    OPTIMIZERS, adafactor_init, adafactor_update, adamw_init, adamw_update,
    make_optimizer,
)
from repro_torch.train.compression import (
    compress_grads, decompress_grads, ef_init,
)
from repro_torch.train.loop import (
    TrainLoopConfig, gcn_train_loop, make_gcn_train_step, make_train_step,
    train_loop,
)

__all__ = [
    "adamw_init", "adamw_update", "adafactor_init", "adafactor_update",
    "OPTIMIZERS", "make_optimizer",
    "compress_grads", "decompress_grads", "ef_init",
    "TrainLoopConfig", "make_train_step", "train_loop",
    "make_gcn_train_step", "gcn_train_loop",
]
