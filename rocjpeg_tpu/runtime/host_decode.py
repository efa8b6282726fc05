"""Host entropy-decode backend selection.

The production host path is the C++ extension (csrc/, loaded via ctypes as
``rocjpeg_tpu.runtime.native``) — the equivalent of the
reference's native CPU front-end (its parser, src/rocjpeg_parser.cpp) plus
the entropy decode its ASIC does in silicon. The pure-Python decoder
(core/entropy.py) is the always-available fallback and the correctness
oracle the native path is tested against.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import List, Optional, Sequence

import numpy as np

from ..core import entropy
from ..core.bitstream import JpegStreamParams

from . import native as _native

NATIVE_AVAILABLE = _native.AVAILABLE


def backend_name() -> str:
    return "native" if NATIVE_AVAILABLE else "python"


def require_native() -> None:
    """Raise RocJpegError(NOT_INITIALIZED) unless the native library and
    its index walker loaded. The device path needs both (without the walker
    DRI=0 images would silently decode on the host), so accelerator
    sessions call this instead of degrading to the Python fallback."""
    if native_index_module() is None:
        from ..status import RocJpegError, Status
        raise RocJpegError(
            Status.NOT_INITIALIZED,
            "native host library unavailable: "
            f"{_native.LOAD_ERROR or 'index walker missing'}")


def native_pack_module():
    """The native module if it supports the wave segment packer, else None."""
    if NATIVE_AVAILABLE and getattr(_native, "PACK_AVAILABLE", False):
        return _native
    return None


def native_index_module():
    """The native module if it supports the virtual-restart index pass
    (rjt_index_scan / rjt_pack_bits), else None."""
    if NATIVE_AVAILABLE and getattr(_native, "INDEX_AVAILABLE", False):
        return _native
    return None


def decode_coefficients(params: JpegStreamParams) -> List[np.ndarray]:
    """Entropy-decode one stream into per-component natural-order coefficient
    planes (blocks_h, blocks_w, 64) int16."""
    if NATIVE_AVAILABLE:
        return _native.decode_scan(params)
    return entropy.decode_scan(params)


def decode_coefficients_batch(
        params_list: Sequence[JpegStreamParams],
        max_workers: Optional[int] = None) -> List[List[np.ndarray]]:
    """Entropy-decode a batch. With the native backend the work fans out over
    a thread pool (the C++ decoder releases the GIL, and additionally splits
    restart segments across threads); the Python fallback runs serially
    (GIL-bound loops gain nothing from threads)."""
    if NATIVE_AVAILABLE and len(params_list) > 1:
        workers = max_workers or min(len(params_list), os.cpu_count() or 1)
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            return list(pool.map(_native.decode_scan, params_list))
    return [decode_coefficients(p) for p in params_list]
