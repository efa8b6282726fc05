"""Public enums and parameter structs.

Python re-expression of the reference C API types (``api/rocjpeg.h``):

- :class:`ChromaSubsampling`  ← ``RocJpegChromaSubsampling`` (rocjpeg.h:86-94)
- :class:`OutputFormat`       ← ``RocJpegOutputFormat``      (rocjpeg.h:124-141)
- :class:`Backend`            ← ``RocJpegBackend``           (rocjpeg.h:176-179)
- :class:`CropRectangle` / :class:`DecodeParams` ← ``RocJpegDecodeParams`` (rocjpeg.h:153-166)
- :class:`DecodedImage`       ← ``RocJpegImage``             (rocjpeg.h:104-107)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

MAX_COMPONENT = 4  # ROCJPEG_MAX_COMPONENT (rocjpeg.h:46)


class ChromaSubsampling(enum.IntEnum):
    """Chroma subsampling; values match ``RocJpegChromaSubsampling``
    (rocjpeg.h:86-94)."""

    CSS_444 = 0
    CSS_440 = 1
    CSS_422 = 2
    CSS_420 = 3
    CSS_411 = 4
    CSS_400 = 5
    CSS_UNKNOWN = -1


class OutputFormat(enum.IntEnum):
    """Decode output formats; values match ``RocJpegOutputFormat``
    (rocjpeg.h:124-141).

    - NATIVE: surface-native plane layout per subsampling —
      444→three planes (444P), 440→three planes with half-height chroma (422V),
      422→packed YUYV single channel, 420→Y plane + interleaved UV (NV12),
      400→single Y plane (Y800).  (rocjpeg.h:125-130)
    - YUV_PLANAR: separate Y, U, V planes at their subsampled dimensions.
    - Y: luma only.
    - RGB: packed interleaved RGB in channel 0 (pitch ≥ 3*width).
    - RGB_PLANAR: R, G, B in channels 0..2.
    """

    NATIVE = 0
    YUV_PLANAR = 1
    Y = 2
    RGB = 3
    RGB_PLANAR = 4


class Backend(enum.IntEnum):
    """Decode backend. The reference exposes HARDWARE (VCN ASIC) and a
    never-implemented HYBRID (rocjpeg.h:176-179; src/rocjpeg_decoder.cpp:74-91
    returns NOT_IMPLEMENTED for HYBRID).

    Here HARDWARE maps to the device compute path and HYBRID stays
    NOT_IMPLEMENTED for drop-in behavioral parity.
    """

    HARDWARE = 0
    HYBRID = 1


@dataclasses.dataclass(frozen=True)
class CropRectangle:
    """Crop ROI; mirrors ``RocJpegDecodeParams.crop_rectangle``
    (rocjpeg.h:155-160). A ROI is *valid* iff 0 < right-left <= width and
    0 < bottom-top <= height (validity rule from src/rocjpeg_decoder.cpp:123-131);
    otherwise the full image is returned."""

    left: int = 0
    top: int = 0
    right: int = 0
    bottom: int = 0

    @property
    def width(self) -> int:
        """Crop width in pixels (``right - left``)."""
        return self.right - self.left

    @property
    def height(self) -> int:
        """Crop height in pixels (``bottom - top``)."""
        return self.bottom - self.top


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    """Decode parameters; mirrors ``RocJpegDecodeParams`` (rocjpeg.h:153-166).
    ``target_dimension`` is declared "(future use)" by the reference and is
    likewise accepted-but-ignored here."""

    output_format: OutputFormat = OutputFormat.NATIVE
    crop_rectangle: CropRectangle = dataclasses.field(default_factory=CropRectangle)
    target_width: int = 0
    target_height: int = 0


class LazyChannel:
    """A per-image view into a batched device array, sliced on first use.

    Decoding returns whole-batch device arrays; materializing ``arr[i]`` per
    image per channel eagerly costs one device dispatch each (tens of
    dispatches per batch). This proxy defers the slice
    until the channel is actually read. It quacks like an array where the
    framework's consumers need it: ``np.asarray``, ``block_until_ready``,
    ``shape``/``dtype``, indexing.
    """

    __slots__ = ("_batch", "_index", "_arr")

    def __init__(self, batch_arr, index: int):
        self._batch = batch_arr
        self._index = index
        self._arr = None

    def _resolve(self):
        if self._arr is None:
            self._arr = self._batch[self._index]
            self._batch = None
        return self._arr

    def __array__(self, dtype=None, copy=None):
        import numpy as np
        return np.asarray(self._resolve(), dtype=dtype)

    def block_until_ready(self):
        """Block until the underlying device computation finishes (the
        jax.Array method, forwarded)."""
        target = self._arr if self._arr is not None else self._batch
        target.block_until_ready()
        return self

    @property
    def shape(self):
        """Shape of this image's channel (batch axis stripped)."""
        if self._arr is not None:
            return self._arr.shape
        return self._batch.shape[1:]

    @property
    def dtype(self):
        """Element dtype (uint8 for all output formats)."""
        return (self._arr if self._arr is not None else self._batch).dtype

    def __getitem__(self, key):
        return self._resolve()[key]

    def __repr__(self):
        return f"LazyChannel(shape={self.shape}, dtype={self.dtype})"


@dataclasses.dataclass
class DecodedImage:
    """Decoded output; mirrors ``RocJpegImage`` (rocjpeg.h:104-107).

    ``channel[i]`` holds a 2-D uint8 array (device or host). ``pitch[i]`` is
    the row stride in bytes of the returned array (== its width in elements;
    unlike the C API the framework allocates outputs, so pitch is always
    tight). Packed formats (YUYV, RGB interleaved) occupy channel 0 with
    pitch 2*W / 3*W respectively, matching the reference layout.
    """

    channel: list  # list[Optional[array]] length MAX_COMPONENT
    pitch: list  # list[int] length MAX_COMPONENT

    @classmethod
    def empty(cls) -> "DecodedImage":
        """A DecodedImage with all channels None and pitches 0 (the caller
        fills channels/pitches, e.g. for ``Decoder.decode_into``)."""
        return cls(channel=[None] * MAX_COMPONENT, pitch=[0] * MAX_COMPONENT)


@dataclasses.dataclass(frozen=True)
class ImageInfo:
    """Result of ``Decoder.get_image_info``; mirrors the out-params of
    ``rocJpegGetImageInfo`` (rocjpeg.h:276-296, src/rocjpeg_decoder.cpp:307-358).

    ``widths``/``heights`` are per-channel arrays of length 4 with the exact
    reference semantics (chroma dims are floor-divided; 400 zeroes chroma)."""

    num_components: int
    subsampling: ChromaSubsampling
    widths: tuple
    heights: tuple


@dataclasses.dataclass(frozen=True)
class TpuDecodeSpec:
    """Per-device decode capability spec — the analog of the per-arch
    ``VcnJpegSpec`` table (src/rocjpeg_vaapi_decoder.cpp:294-305, struct at
    src/rocjpeg_vaapi_decoder.h:71-75). (The class name is kept for API
    compatibility.)

    ``num_decode_lanes`` plays the role of ``num_jpeg_cores``: it is the
    batch-chunk width used by ``decode_batched`` (the reference chunks by
    cores, src/rocjpeg_decoder.cpp:208-218).
    """

    name: str
    num_decode_lanes: int = 32
    can_convert_to_rgb: bool = True  # software path: always
    can_roi_decode: bool = True  # ROI slicing fused into the layout stage
    min_width: int = 64  # reference min 64x64 (vaapi_decoder.cpp:290)
    min_height: int = 64
    max_width: int = 16384  # MI300/Navi-class max (docs rst:25-28)
    max_height: int = 16384


# Per-platform capability rows, keyed by ``jax.Device.platform`` — the
# analog of the per-arch VcnJpegSpec constants compiled into the reference
# (src/rocjpeg_vaapi_decoder.cpp:294-305, selected at InitializeDecoder,
# :365-422). All capabilities are software here, so only the chunk width
# varies. The GPU's 32 is untuned: carried over, not measured (ROADMAP C5).
SPEC_TABLE = {
    "gpu": TpuDecodeSpec(name="gpu", num_decode_lanes=32),
    "cpu": TpuDecodeSpec(name="cpu", num_decode_lanes=8),
}


def spec_for_device(device) -> TpuDecodeSpec:
    """Capability spec for a ``jax.Device`` — the GetCurrentVcnJpegSpec
    lookup (vaapi_decoder.cpp:412-417) keyed on the device's platform and
    named after its ``device_kind``. A platform without a row is an error
    (RocJpegError NOT_INITIALIZED), not a default."""
    from .status import RocJpegError, Status

    platform = getattr(device, "platform", "")
    spec = SPEC_TABLE.get(platform)
    if spec is None:
        raise RocJpegError(Status.NOT_INITIALIZED,
                           f"no decode spec for platform {platform!r}")
    kind = getattr(device, "device_kind", "") or platform
    return dataclasses.replace(spec, name=kind)
