from .losses import (custom_ce_loss, entropy, l2_loss, logsumexp_loss,
                     sup_con_loss, sym_ce_loss)
from .optim import make_lr_schedule, make_optimizer
from .trainer import (TrainState, create_train_state, make_encode_step,
                      make_gl_eval_step, make_gl_train_step,
                      make_mlp_eval_step, make_mlp_train_step,
                      metrics_to_host, params_finite, resolve_device)

__all__ = [
    "custom_ce_loss", "entropy", "l2_loss", "logsumexp_loss",
    "sup_con_loss", "sym_ce_loss", "make_lr_schedule", "make_optimizer",
    "TrainState", "create_train_state", "make_encode_step",
    "make_gl_eval_step", "make_gl_train_step", "make_mlp_eval_step",
    "make_mlp_train_step", "metrics_to_host", "params_finite",
    "resolve_device",
]
