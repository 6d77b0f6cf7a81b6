from .augment import (Lighting, RandAugment, Transform, cutout_default,
                      normalize_batch)
from .datasets import (CHANNEL_STATS, DATASETS, DatasetSpec, load_dataset,
                       parse_synth_overrides, synth_kwargs_from_opt,
                       synthetic_dataset)
from .device_aug import DeviceTransform
from .pipeline import (BatchLoader, ScoredDataset, TwoCropBatchLoader,
                       downsample_by_stride, select_base_indices)
from .pseudo_label import PseudoLabelStore, convert_outputs_to_pseudo_labels

__all__ = [
    "Lighting", "RandAugment", "Transform", "cutout_default",
    "normalize_batch",
    "CHANNEL_STATS", "DATASETS", "DatasetSpec", "load_dataset",
    "parse_synth_overrides", "synth_kwargs_from_opt", "synthetic_dataset",
    "BatchLoader", "ScoredDataset", "TwoCropBatchLoader",
    "downsample_by_stride", "select_base_indices", "DeviceTransform",
    "PseudoLabelStore", "convert_outputs_to_pseudo_labels",
]
