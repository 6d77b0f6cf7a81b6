"""Shared pieces of the benchmark's own tests: the tiny CPU sizes of each
cell (widths cut, which only these tests do) and the card fixture."""
import pytest

# every cell at a size the CPU runs in seconds; the graph op's k stays at
# the adversarial driver's fixed 25
TINY = {
    "c10_r18_gl.train": {
        "config": {"image_shape": [8, 8, 3], "train_images": 200,
                   "batch_size": 40, "base_per_class": 2, "knn_k": 5},
        "traffic": {"warmup_steps": 1}},
    "c10_r18_gl.eval60k": {
        "config": {"image_shape": [8, 8, 3], "train_images": 300,
                   "test_images": 100, "base_per_class": 3,
                   "eval_knn_k": 10, "eval_batch": 64},
        "traffic": {"warmup_evals": 1}},
    "fmnist_r18_pgd.train": {
        "config": {"image_shape": [8, 8, 1], "train_images": 200,
                   "batch_size": 40, "base_per_class": 2},
        "traffic": {"warmup_steps": 1}},
}


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def cuda_device():
    """Skips the test where no CUDA device is present (decided here, not
    at import: the test workers import every file)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
