"""The training step and loop and the serving steps (the port of
``repro.train``)."""

from repro_torch.train.loop import LoopConfig, LoopState, TrainLoop
from repro_torch.train.step import (TrainConfig, make_serve_step,
                                    make_train_step)

__all__ = ["LoopConfig", "LoopState", "TrainLoop", "TrainConfig",
           "make_train_step", "make_serve_step"]
