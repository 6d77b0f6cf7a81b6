from .augment import (Lighting, RandAugment, Transform, cutout_default,
                      normalize_batch)
from .datasets import (CHANNEL_STATS, DATASETS, DatasetSpec, load_dataset,
                       parse_synth_overrides, synth_kwargs_from_opt,
                       synthetic_dataset)
from .pipeline import (BatchLoader, ScoredDataset, TwoCropBatchLoader,
                       downsample_by_stride, select_base_indices)

__all__ = [
    "Lighting", "RandAugment", "Transform", "cutout_default",
    "normalize_batch",
    "CHANNEL_STATS", "DATASETS", "DatasetSpec", "load_dataset",
    "parse_synth_overrides", "synth_kwargs_from_opt", "synthetic_dataset",
    "BatchLoader", "ScoredDataset", "TwoCropBatchLoader",
    "downsample_by_stride", "select_base_indices",
]
