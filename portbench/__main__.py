"""``python -m portbench``: one run of one cell (see ``run.py``)."""
import os
import sys
from pathlib import Path

# every build and kernel cache inside the checkout, at fixed paths, before
# torch is imported; the program's own nvcc builds go to build/torch_kernels
_BUILD = Path(__file__).resolve().parent.parent / "build"
os.environ["TRITON_CACHE_DIR"] = str(_BUILD / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_BUILD / "torch_extensions")
os.environ["USE_FLAX"] = "0"

from .run import main  # noqa: E402

sys.exit(main())
