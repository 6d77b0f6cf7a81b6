from .checkpoint import (latest_step, load_state_dict_tolerant,
                         restore_checkpoint, save_checkpoint)
from .jax_params import params_from_jax
from .meters import (AverageMeter, AverageMeterSet, FileLogger, Throughput,
                     UnifLabelSampler, parameter_count, parameters_string,
                     topk_accuracy)
from .profiling import annotate, trace_steps

__all__ = [
    "latest_step", "load_state_dict_tolerant", "restore_checkpoint",
    "save_checkpoint", "params_from_jax", "AverageMeter", "AverageMeterSet",
    "FileLogger", "Throughput", "UnifLabelSampler", "parameter_count",
    "parameters_string", "topk_accuracy", "annotate", "trace_steps",
]
