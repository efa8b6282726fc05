"""C-style functional API — the status-returning mirror of the 9-function
reference C surface (reference ``api/rocjpeg.h:204-343``).

Two consumers:

1. Python users who want a literal translation target for existing rocJPEG
   C call sites (every function returns a :class:`~rocjpeg_tpu.status.Status`
   instead of raising).
2. The embedded C ABI library ``librocjpeg_tpu.so`` (``csrc/rocjpeg_capi.cpp``),
   which exposes the actual ``extern "C"`` symbols (``rocJpegCreate``,
   ``rocJpegDecode``, ...) and forwards here. For that path the destination
   channels arrive as raw pointer integers and are filled via
   ``ctypes.memmove`` with the caller's pitch, matching the reference's
   caller-allocated ``RocJpegImage`` contract (``api/rocjpeg.h:104-107``,
   copy semantics of ``src/rocjpeg_decoder.cpp:372-399``) — except buffers
   are host memory, since the device here is reached through JAX
   rather than HIP-visible VRAM.

Unlike the object API (:mod:`rocjpeg_tpu.api`), nothing raises: exceptions
are captured into a per-handle last-error string
(``src/rocjpeg_api_decoder_handle.h:77`` semantics) and translated to a
status code (``src/rocjpeg_api.cpp:168-174``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from . import api
from .status import RocJpegError, Status, get_error_name  # noqa: F401 (re-export)
from .types import (Backend, ChromaSubsampling, CropRectangle, DecodeParams,
                    MAX_COMPONENT, OutputFormat)

__all__ = [
    "stream_create", "stream_parse", "stream_destroy",
    "create", "destroy", "get_image_info", "decode", "decode_batched",
    "get_error_name", "get_last_error",
]

Dest = Union[int, np.ndarray, None]


def _capture(handle, exc) -> Status:
    """Exception -> status translation + per-handle error capture
    (src/rocjpeg_api.cpp:168-174, api_decoder_handle.h:77)."""
    msg = str(exc)
    if handle is not None:
        try:
            handle._last_error = msg
        except Exception:
            pass
    if isinstance(exc, RocJpegError):
        return exc.status
    if isinstance(exc, MemoryError):
        return Status.OUTOF_MEMORY
    return Status.RUNTIME_ERROR


def get_last_error(handle) -> str:
    """Per-handle captured error string (the reference stores one on every
    handle via CaptureError but never exposes a getter; we do)."""
    return getattr(handle, "_last_error", "")


# ----------------------------------------------------------------------
# Stream functions (rocJpegStreamCreate/Parse/Destroy, api.cpp:41-96)

def stream_create() -> Tuple[Status, Optional[api.JpegStream]]:
    """rocJpegStreamCreate analog (api.cpp:41-52): returns
    (SUCCESS, empty stream handle); (NOT_INITIALIZED, None) on failure."""
    try:
        return Status.SUCCESS, api.JpegStream()
    except Exception:
        return Status.NOT_INITIALIZED, None


def stream_parse(stream: api.JpegStream, data: bytes) -> Status:
    """rocJpegStreamParse analog (api.cpp:68-82): parse ``data`` into the
    handle. Returns BAD_JPEG on malformed input, INVALID_PARAMETER on null
    arguments; the error text is captured on the handle (see
    :func:`get_last_error`)."""
    if stream is None or data is None:
        return Status.INVALID_PARAMETER
    try:
        stream.parse(bytes(data))
        return Status.SUCCESS
    except Exception as e:
        return _capture(stream, e)


def stream_destroy(stream: api.JpegStream) -> Status:
    """rocJpegStreamDestroy analog (api.cpp:88-96). Resources are GC-owned;
    this exists for call-site parity (INVALID_PARAMETER on None, SUCCESS
    otherwise)."""
    return Status.INVALID_PARAMETER if stream is None else Status.SUCCESS


# ----------------------------------------------------------------------
# Decoder functions

def create(backend: int = int(Backend.HARDWARE), device_id: int = 0,
           **kwargs) -> Tuple[Status, Optional[api.Decoder]]:
    """rocJpegCreate analog (api.cpp:107-120)."""
    try:
        return Status.SUCCESS, api.Decoder(Backend(backend), device_id,
                                           **kwargs)
    except Exception as e:
        return _capture(None, e), None


def destroy(handle: api.Decoder) -> Status:
    """rocJpegDestroy analog (api.cpp:126-132). Resources are GC-owned;
    INVALID_PARAMETER on None, SUCCESS otherwise."""
    return Status.INVALID_PARAMETER if handle is None else Status.SUCCESS


def get_image_info(handle: api.Decoder, stream: api.JpegStream
                   ) -> Tuple[Status, int, int, Tuple[int, ...], Tuple[int, ...]]:
    """rocJpegGetImageInfo analog (api.cpp:134-154). Returns
    (status, num_components, subsampling, widths[4], heights[4])."""
    zero4 = (0, 0, 0, 0)
    if handle is None or stream is None:
        return Status.INVALID_PARAMETER, 0, int(ChromaSubsampling.CSS_UNKNOWN), zero4, zero4
    try:
        info = handle.get_image_info(stream)
        return (Status.SUCCESS, info.num_components, int(info.subsampling),
                info.widths, info.heights)
    except Exception as e:
        return _capture(handle, e), 0, int(ChromaSubsampling.CSS_UNKNOWN), zero4, zero4


# Pitch-honoring channel write: shared with the object API's decode_into
# (one implementation of the reference's CopyChannel semantics).
_write_channel = api.write_channel_into


def _params_from_plain(output_format: int, crop: Sequence[int]) -> DecodeParams:
    l, t, r, b = (int(x) for x in crop)
    return DecodeParams(output_format=OutputFormat(output_format),
                        crop_rectangle=CropRectangle(l, t, r, b))


def decode(handle: api.Decoder, stream: api.JpegStream,
           output_format: int, crop: Sequence[int],
           dest_channels: Sequence[Dest], dest_pitches: Sequence[int]
           ) -> Status:
    """rocJpegDecode analog (api.cpp:192-209): decode and write the decoded
    planes into caller buffers (pointer ints or numpy arrays)."""
    return decode_batched(handle, [stream], output_format, crop,
                          [dest_channels], [dest_pitches])


def decode_batched(handle: api.Decoder, streams: Sequence[api.JpegStream],
                   output_format: int, crop: Sequence[int],
                   dest_channels: Sequence[Sequence[Dest]],
                   dest_pitches: Sequence[Sequence[int]]) -> Status:
    """rocJpegDecodeBatched analog (api.cpp:222-237)."""
    if (handle is None or streams is None or len(streams) == 0
            or len(dest_channels) != len(streams)
            or len(dest_pitches) != len(streams)):
        return Status.INVALID_PARAMETER
    try:
        from .types import DecodedImage
        params = _params_from_plain(output_format, crop)
        dests = []
        for chans, pitches in zip(dest_channels, dest_pitches):
            d = DecodedImage.empty()
            for ci in range(min(MAX_COMPONENT, len(chans))):
                c = chans[ci]
                # Null pointer ints mean "caller did not allocate this
                # plane" (reference writes only caller-allocated channels).
                if isinstance(c, (int, np.integer)) and int(c) == 0:
                    c = None
                d.channel[ci] = c
                d.pitch[ci] = int(pitches[ci]) if ci < len(pitches) else 0
            dests.append(d)
        handle.decode_into(list(streams), dests, params)
        return Status.SUCCESS
    except Exception as e:
        return _capture(handle, e)
