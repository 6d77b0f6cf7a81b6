"""ctypes binding for the native (C++) augmentation backend.

Twin of ``graphlearninglayer_tpu/data/native.py``, over the port's own copy
of the source, ``native/augment.cpp``: a small multithreaded C++ library of
the transform stack, bit-exact with PIL per op, driven through ctypes.

The library is compiled with ``g++`` the first time it is needed, into
``build/native/libgllaug-<hash>.so`` at the repository root (a directory
that ``.gitignore`` lists); the hash covers the source and the flags.  When
no compiler is there, :func:`native_available` is False and the loader
takes the PIL path (``data/augment.py``).  On the machine with the card,
which has no PIL, this is the only augmentation backend.

Only the random parameter *streams* differ from the PIL path, since numpy
Generator streams are not reproducible from C; the same seeds give the same
bytes as the JAX package's library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["native_available", "augment_batch_native",
           "normalize_batch_native", "apply_op_native", "OP_IDS"]

_SRC = Path(__file__).resolve().parent / "native" / "augment.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False

# RandAugment op ids, in the order of augment.py's op list
OP_IDS = {
    "autocontrast": 0, "brightness": 1, "color": 2, "contrast": 3,
    "equalize": 4, "identity": 5, "posterize": 6, "rotate": 7,
    "sharpness": 8, "shear_x": 9, "shear_y": 10, "solarize": 11,
    "translate_x": 12, "translate_y": 13,
}

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libgllaug-{digest[:12]}.so"


def _build() -> Path | None:
    """The library's path, compiled first if needed; None when ``g++``
    fails or is missing."""
    out = _target()
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC),
                        "-lpthread"],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        return None
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        i, d = ctypes.c_int, ctypes.c_double
        lib.gll_apply_op.argtypes = [_u8p, _u8p, i, i, i, i, d, i]
        lib.gll_apply_op.restype = None
        lib.gll_augment_batch.argtypes = [_u8p, _u8p, i, i, i, i, _u64p,
                                          i, i, i, i, i, i]
        lib.gll_augment_batch.restype = None
        lib.gll_normalize_batch.argtypes = [_u8p, _f32p, ctypes.c_int64, i,
                                            _f32p, _f32p, i]
        lib.gll_normalize_batch.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native augmentation library unavailable (g++ "
                           "could not build data/native/augment.cpp)")
    return lib


def apply_op_native(img: np.ndarray, op: str | int, v: float,
                    sign: bool = False) -> np.ndarray:
    """Apply one RandAugment op to a uint8 HWC image."""
    lib = _require()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty_like(img)
    op_id = OP_IDS[op] if isinstance(op, str) else int(op)
    lib.gll_apply_op(img, out, h, w, c, op_id, float(v), int(sign))
    return out


def augment_batch_native(batch: np.ndarray, seeds: np.ndarray, rand_n: int,
                         rotation: int, flip: bool, pad: int,
                         pad_reflect: bool, threads: int = 0) -> np.ndarray:
    """Full weak/strong transform for a uint8 NHWC batch (one seed per
    image): [rotate] -> [flip] -> pad+crop -> RandAugment(rand_n) -> cutout.
    """
    lib = _require()
    batch = np.ascontiguousarray(batch, np.uint8)
    n, h, w, c = batch.shape
    seeds = np.ascontiguousarray(seeds, np.uint64)
    if seeds.shape != (n,):
        raise ValueError("seeds must have shape (n,)")
    out = np.empty_like(batch)
    threads = threads or min(n, os.cpu_count() or 1)
    lib.gll_augment_batch(batch, out, n, h, w, c, seeds, int(rand_n),
                          int(rotation), int(flip), int(pad),
                          int(pad_reflect), int(threads))
    return out


def normalize_batch_native(batch: np.ndarray, mean, std,
                           threads: int = 0) -> np.ndarray:
    """uint8 NHWC -> float32 normalized NHWC ((x/255 - mean) / std)."""
    lib = _require()
    batch = np.ascontiguousarray(batch, np.uint8)
    c = batch.shape[-1]
    npix = batch.size // c
    out = np.empty(batch.shape, np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    threads = threads or (os.cpu_count() or 1)
    lib.gll_normalize_batch(batch.reshape(-1), out.reshape(-1), npix, c,
                            mean, std, int(threads))
    return out
