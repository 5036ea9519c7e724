from repro_torch.train.loop import TrainRunConfig, train
from repro_torch.train.step import (
    loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = ["TrainRunConfig", "loss_fn", "make_prefill_step",
           "make_serve_step", "make_train_step", "train"]
