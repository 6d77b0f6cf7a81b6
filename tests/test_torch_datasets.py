"""The port's copy of the synthetic datasets is byte-identical to the JAX
package's for the same seed and arguments."""
import numpy as np
import pytest

from graphlearninglayer_tpu.data import augment as jaugment
from graphlearninglayer_tpu.data import datasets as jdatasets
from graphlearninglayer_tpu_torch.data import datasets as tdatasets


@pytest.mark.parametrize("kw", [
    dict(num_classes=10, image_shape=(32, 32, 3), n_train=96, n_test=32,
         seed=3),
    dict(num_classes=4, image_shape=(28, 28, 1), n_train=64, n_test=16,
         seed=0, label_noise=0.2),
    dict(num_classes=10, image_shape=(32, 32, 3), n_train=80, n_test=24,
         seed=5, class_sep=1.5, modes_per_class=2, label_noise=0.1,
         noise_std=0.3, latent_dim=8),
], ids=["legacy-cifar", "legacy-mnist-noise", "hard-cifar"])
def test_synthetic_dataset_byte_identical(kw):
    want = jdatasets.synthetic_dataset(**kw)
    got = tdatasets.synthetic_dataset(**kw)
    for field in ("train_images", "train_labels", "test_images",
                  "test_labels"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), field
    assert got.num_classes == want.num_classes
    assert got.image_shape == want.image_shape


def test_channel_stats_match():
    assert tdatasets.CHANNEL_STATS == jaugment.CHANNEL_STATS
