"""Training: the train and eval steps (`step`), checkpoints
(`checkpoints`) and the driver (`trainer.train`, or `python -m
stt_tpu_torch.train`)."""

from stt_tpu_torch.train.step import (
    Batch,
    StepMetrics,
    TrainState,
    create_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
    make_train_step_audio,
)

__all__ = [
    "Batch",
    "StepMetrics",
    "TrainState",
    "create_optimizer",
    "create_train_state",
    "make_eval_step",
    "make_train_step",
    "make_train_step_audio",
]
