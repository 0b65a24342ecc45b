"""ctypes bindings for the native sam2io library (counterpart of
`sam2_opt_tpu/io/native.py`).

The source is the repository's `csrc/sam2io.cpp`, which both packages
share: a threaded libjpeg decode with a half-pixel bilinear resize, the
pycoco RLE codec and the box of a mask. The port builds it at first use
with `g++ -O3 -fPIC -shared ... -ljpeg -lpthread` into
`build/sam2_opt_tpu_torch/libsam2io-<hash>.so` (the hash covers the source
and the flags, as `kernels/_build.py::library_path` does) and never loads
the library committed beside the source. Where the build or the load fails
(no compiler, no libjpeg headers), `available()` is False and every entry
point returns None: callers then take the JAX package's pure Python path
(`io/video.py` decodes JPEG frames with Pillow).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from sam2_opt_tpu_torch.kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "sam2io.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LINK_FLAGS = ("-ljpeg", "-lpthread")

_LIB = None  # the loaded library, False once its build or load failed
_ERROR: Optional[str] = None
_LOCK = threading.Lock()
_U8 = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libsam2io-{digest.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS], check=True,
                   capture_output=True, text=True, timeout=120)
    os.replace(tmp, out)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, u32 = ctypes.c_int, ctypes.POINTER(ctypes.c_uint32)
    for name, args, res in (
            ("jpeg_dims", [ctypes.c_char_p, ctypes.POINTER(c_int), ctypes.POINTER(c_int)], c_int),
            ("decode_jpeg_batch", [ctypes.c_char_p, c_int, _U8, c_int, c_int, c_int], c_int),
            ("rle_encode", [_U8, c_int, c_int, u32, c_int], c_int),
            ("rle_decode", [u32, c_int, c_int, c_int, _U8], None),
            ("mask_to_box", [_U8, c_int, c_int, ctypes.POINTER(ctypes.c_int32)], None)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is None:
            path = library_path()
            try:
                if not path.exists():
                    _compile(path)
                _LIB = _declare(ctypes.CDLL(str(path)))
            except subprocess.CalledProcessError as e:
                _LIB, _ERROR = False, f"g++ failed: {e.stderr.strip()}"
            except (OSError, subprocess.TimeoutExpired) as e:
                _LIB, _ERROR = False, f"{type(e).__name__}: {e}"
        return _LIB or None


def available() -> bool:
    """Whether the library built and loaded (built on the first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable, or None."""
    _load()
    return _ERROR


def jpeg_dims(path: str):
    """(h, w) of a JPEG, or None on failure or without the library."""
    lib = _load()
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_jpeg_batch(paths: List[str], size: int,
                      num_threads: Optional[int] = None) -> Optional[np.ndarray]:
    """Threaded decode of JPEG files into uint8 [N, size, size, 3], each
    resized with the half-pixel bilinear filter (after libjpeg's DCT
    prescale); None without the library or if any file failed."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((len(paths), size, size, 3), np.uint8)
    threads = num_threads or min(8, os.cpu_count() or 1)
    failures = lib.decode_jpeg_batch("\n".join(paths).encode(), len(paths),
                                     out.ctypes.data_as(_U8), size, size, threads)
    return None if failures else out


def rle_encode(mask: np.ndarray) -> Optional[dict]:
    """pycoco uncompressed RLE of a bool [H, W] mask ({"size", "counts"};
    counts start with a background run, 0 when the first pixel is set)."""
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = m.shape
    buf = np.empty(h * w + 2, np.uint32)
    n = lib.rle_encode(m.ctypes.data_as(_U8), h, w,
                       buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), buf.size)
    return None if n < 0 else {"size": [h, w], "counts": buf[:n].tolist()}


def rle_decode(rle: dict) -> Optional[np.ndarray]:
    """bool [H, W] mask of an uncompressed RLE."""
    lib = _load()
    if lib is None:
        return None
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.uint32)
    out = np.zeros((h, w), np.uint8)
    lib.rle_decode(counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(counts), h, w,
                   out.ctypes.data_as(_U8))
    return out.astype(bool)


def mask_to_box(mask: np.ndarray) -> Optional[np.ndarray]:
    """int32 xyxy box of a [H, W] mask, as `sam2io.cpp::mask_to_box` gives it."""
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask.astype(np.uint8))
    box = np.zeros(4, np.int32)
    lib.mask_to_box(m.ctypes.data_as(_U8), m.shape[0], m.shape[1],
                    box.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return box
