from .datasets import CHANNEL_STATS, DatasetSpec, synthetic_dataset

__all__ = ["CHANNEL_STATS", "DatasetSpec", "synthetic_dataset"]
