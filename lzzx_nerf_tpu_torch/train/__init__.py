"""The training stages: head, lips finetune and torso."""
from .losses import binary_entropy, entropy_loss, head_losses, torso_losses
from .metrics import PSNRMeter, psnr
from .optim import HeadOptimizer, param_label_fn
from .trainer import (TrainState, jitter_regulariser, make_eval_step,
                      make_torso_train_step, make_train_step)

__all__ = ["HeadOptimizer", "PSNRMeter", "TrainState", "binary_entropy",
           "entropy_loss", "head_losses", "jitter_regulariser",
           "make_eval_step", "make_torso_train_step", "make_train_step",
           "param_label_fn", "psnr", "torso_losses"]
