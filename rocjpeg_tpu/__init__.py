"""rocjpeg_tpu — a JAX JPEG decode framework for accelerators.

A from-scratch rebuild of the capability surface of AMD's rocJPEG SDK:
everything rocJPEG delegates to the VCN fixed-function ASIC — Huffman
entropy decode, dequantization, 8x8 IDCT, chroma upsampling, color
conversion — is implemented in software (JAX/XLA and a Pallas kernel on the
device; C++ on the host), exposed through a session API mirroring the
9-function C API (api/rocjpeg.h:204-343).
"""

import os as _os

# Persistent compile cache. JAX reads JAX_COMPILATION_CACHE_DIR itself when
# it is set; otherwise the cache lives in one fixed directory of the
# checkout (listed in .gitignore), so every process of a run shares it.
CACHE_DIR = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from .status import RocJpegError, Status, get_error_name
from .types import (Backend, ChromaSubsampling, CropRectangle, DecodedImage,
                    DecodeParams, ImageInfo, OutputFormat, TpuDecodeSpec)

__version__ = "0.5.0"
