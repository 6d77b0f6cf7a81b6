from .harness import encode_dataset, test_gl_transductive

__all__ = ["encode_dataset", "test_gl_transductive"]
