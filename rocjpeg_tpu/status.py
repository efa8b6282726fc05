"""Status codes and error model.

Mirrors the reference C API's ``RocJpegStatus`` enum (reference:
``api/rocjpeg.h:53-67``) and its exception-to-status translation at the API
edge (``src/rocjpeg_api.cpp:168-174``, ``src/rocjpeg_api_decoder_handle.h:77``).

The framework is Python-first, so errors surface both ways:
raise :class:`RocJpegError` (carrying a :class:`Status`) from the object API,
and return :class:`Status` from the C-style functional API in
``rocjpeg_tpu.capi``.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Operation status codes; values match ``RocJpegStatus`` in the reference
    (``api/rocjpeg.h:53-67``)."""

    SUCCESS = 0
    NOT_INITIALIZED = -1
    INVALID_PARAMETER = -2
    BAD_JPEG = -3
    JPEG_NOT_SUPPORTED = -4
    OUTOF_MEMORY = -5
    EXECUTION_FAILED = -6
    ARCH_MISMATCH = -7
    INTERNAL_ERROR = -8
    IMPLEMENTATION_NOT_SUPPORTED = -9
    HW_JPEG_DECODER_NOT_SUPPORTED = -10
    RUNTIME_ERROR = -11
    NOT_IMPLEMENTED = -12


# Error-name strings match rocJpegGetErrorName (src/rocjpeg_api.cpp:246-277).
_ERROR_NAMES = {
    Status.SUCCESS: "ROCJPEG_STATUS_SUCCESS",
    Status.NOT_INITIALIZED: "ROCJPEG_STATUS_NOT_INITIALIZED",
    Status.INVALID_PARAMETER: "ROCJPEG_STATUS_INVALID_PARAMETER",
    Status.BAD_JPEG: "ROCJPEG_STATUS_BAD_JPEG",
    Status.JPEG_NOT_SUPPORTED: "ROCJPEG_STATUS_JPEG_NOT_SUPPORTED",
    Status.OUTOF_MEMORY: "ROCJPEG_STATUS_OUTOF_MEMORY",
    Status.EXECUTION_FAILED: "ROCJPEG_STATUS_EXECUTION_FAILED",
    Status.ARCH_MISMATCH: "ROCJPEG_STATUS_ARCH_MISMATCH",
    Status.INTERNAL_ERROR: "ROCJPEG_STATUS_INTERNAL_ERROR",
    Status.IMPLEMENTATION_NOT_SUPPORTED: "ROCJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED",
    Status.HW_JPEG_DECODER_NOT_SUPPORTED: "ROCJPEG_STATUS_HW_JPEG_DECODER_NOT_SUPPORTED",
    Status.RUNTIME_ERROR: "ROCJPEG_STATUS_RUNTIME_ERROR",
    Status.NOT_IMPLEMENTED: "ROCJPEG_STATUS_NOT_IMPLEMENTED",
}


def get_error_name(status: Status | int) -> str:
    """Return the symbolic name for a status code.

    Mirrors ``rocJpegGetErrorName`` (reference ``src/rocjpeg_api.cpp:246-277``),
    including the unknown-code fallback.
    """
    try:
        return _ERROR_NAMES[Status(status)]
    except ValueError:
        return "UNKNOWN_ROCJPEG_STATUS"


class RocJpegError(Exception):
    """Exception carrying a :class:`Status`; analog of ``RocJpegException``
    (reference ``src/rocjpeg_commons.h:86-111``)."""

    def __init__(self, status: Status, message: str = ""):
        self.status = Status(status)
        self.message = message or get_error_name(status)
        super().__init__(f"{get_error_name(self.status)}: {self.message}")
