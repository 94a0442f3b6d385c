"""Training: the train and eval steps, the optimizers (SGD, Adam/AdamW,
Adafactor, the plateau scaler) with their parameter groups and schedules,
loss and accuracy over the model's endpoints."""
from avt_tpu_torch.train.ops import basic_loss_accuracy, mode_over_frames
from avt_tpu_torch.train.optim import (
    SGD,
    Adafactor,
    Adam,
    ReduceLROnPlateau,
    build_optimizer,
    build_schedule,
    cosine_schedule,
    multistep_schedule,
    warmup_schedule,
)
from avt_tpu_torch.train.step import make_eval_step, make_train_step, weighted_loss_sum

__all__ = [
    "Adafactor", "Adam", "ReduceLROnPlateau", "SGD", "basic_loss_accuracy", "build_optimizer", "build_schedule", "cosine_schedule",
    "make_eval_step", "make_train_step", "mode_over_frames", "multistep_schedule",
    "warmup_schedule", "weighted_loss_sum",
]
