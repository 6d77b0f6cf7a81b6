from .harness import encode_dataset, test_gl_transductive, test_network
from .visualize import (embed_2d, linear_probe_accuracy, plot_embedding,
                        visualize)

__all__ = ["encode_dataset", "test_gl_transductive", "test_network",
           "embed_2d", "linear_probe_accuracy", "plot_embedding",
           "visualize"]
