"""Training: the train, SSL and eval steps, the multi-step, the optimizers (SGD,
Adam/AdamW, Adafactor, the plateau scaler) with their parameter groups and
schedules, loss and accuracy over the model's endpoints, the meters, the
checkpoints and the training loop."""
from avt_tpu_torch.train.checkpoint import BEST_NAME, CKPT_NAME, restore_checkpoint, save_checkpoint
from avt_tpu_torch.train.loop import Preempted, run_training, train_one_epoch
from avt_tpu_torch.train.meters import MetricLogger, SmoothedValue
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
from avt_tpu_torch.train.step import (
    make_eval_step,
    make_multi_step,
    make_ssl_train_step,
    make_train_step,
    step_generator,
    weighted_loss_sum,
)

__all__ = [
    "Adafactor", "Adam", "BEST_NAME", "CKPT_NAME", "MetricLogger", "Preempted",
    "ReduceLROnPlateau", "SGD", "SmoothedValue", "basic_loss_accuracy", "build_optimizer",
    "build_schedule", "cosine_schedule", "make_eval_step", "make_multi_step",
    "make_ssl_train_step", "make_train_step",
    "mode_over_frames", "multistep_schedule", "restore_checkpoint", "run_training",
    "save_checkpoint", "step_generator", "train_one_epoch", "warmup_schedule",
    "weighted_loss_sum",
]
