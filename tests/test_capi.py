"""C ABI tests: the status-returning functional API (rocjpeg_tpu.capi), the
embedded-CPython shared library (build/librocjpeg_tpu.so) driven in-process
via ctypes, and the C sample binary driven as a subprocess — the coverage
the reference gets from building samples against librocjpeg.so
(test/CMakeLists.txt:53-207)."""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from rocjpeg_tpu import capi
from rocjpeg_tpu.core import golden
from rocjpeg_tpu.status import Status
from rocjpeg_tpu.testing import encoder
from rocjpeg_tpu.types import OutputFormat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jpeg_420():
    return encoder.encode_planes(
        encoder.random_planes("420", 128, 96, seed=3), "420",
        restart_interval=4)


# ----------------------------------------------------------------------
# Python-level functional API

def test_stream_lifecycle(jpeg_420):
    st, stream = capi.stream_create()
    assert st == Status.SUCCESS
    assert capi.stream_parse(stream, jpeg_420) == Status.SUCCESS
    assert capi.stream_destroy(stream) == Status.SUCCESS
    assert capi.stream_destroy(None) == Status.INVALID_PARAMETER


def test_parse_bad_jpeg_captures_error():
    _, stream = capi.stream_create()
    assert capi.stream_parse(stream, b"\x00\x01garbage") == Status.BAD_JPEG
    assert capi.get_last_error(stream) != ""


def test_create_bad_backend():
    st, handle = capi.create(backend=1)  # HYBRID
    assert st == Status.NOT_IMPLEMENTED and handle is None
    st, handle = capi.create(backend=7)
    assert st != Status.SUCCESS and handle is None


def test_get_image_info(jpeg_420):
    _, stream = capi.stream_create()
    capi.stream_parse(stream, jpeg_420)
    st, handle = capi.create()
    assert st == Status.SUCCESS
    st, nc, css, widths, heights = capi.get_image_info(handle, stream)
    assert st == Status.SUCCESS
    assert (nc, css) == (3, 3)  # 3 components, CSS_420
    assert widths[:3] == (128, 64, 64)
    assert heights[:3] == (96, 48, 48)


def test_decode_into_numpy(jpeg_420):
    _, stream = capi.stream_create()
    capi.stream_parse(stream, jpeg_420)
    _, handle = capi.create()
    ref = golden.decode(jpeg_420, OutputFormat.RGB)[0][0]
    dest = np.zeros(ref.size, np.uint8)
    st = capi.decode(handle, stream, int(OutputFormat.RGB), (0, 0, 0, 0),
                     [dest, None, None, None], [3 * 128, 0, 0, 0])
    assert st == Status.SUCCESS
    np.testing.assert_array_equal(dest.reshape(ref.shape), ref)


def test_decode_into_pointer_with_padded_pitch(jpeg_420):
    """Caller pitch > row bytes: rows land at pitch offsets, padding intact
    (CopyChannel semantics, src/rocjpeg_decoder.cpp:372-399)."""
    _, stream = capi.stream_create()
    capi.stream_parse(stream, jpeg_420)
    _, handle = capi.create()
    ref = golden.decode(jpeg_420, OutputFormat.Y)[0][0]
    h, w = ref.shape
    pitch = w + 64
    dest = np.full(h * pitch, 0xAB, np.uint8)
    st = capi.decode(handle, stream, int(OutputFormat.Y), (0, 0, 0, 0),
                     [dest.ctypes.data, 0, 0, 0], [pitch, 0, 0, 0])
    assert st == Status.SUCCESS
    rows = dest.reshape(h, pitch)
    np.testing.assert_array_equal(rows[:, :w], ref)
    assert (rows[:, w:] == 0xAB).all()  # padding untouched


def test_decode_pitch_too_small(jpeg_420):
    _, stream = capi.stream_create()
    capi.stream_parse(stream, jpeg_420)
    _, handle = capi.create()
    dest = np.zeros(3 * 128 * 96, np.uint8)
    st = capi.decode(handle, stream, int(OutputFormat.RGB), (0, 0, 0, 0),
                     [dest, None, None, None], [100, 0, 0, 0])
    assert st == Status.INVALID_PARAMETER
    assert "pitch" in capi.get_last_error(handle)


def test_decode_null_primary_channel(jpeg_420):
    _, stream = capi.stream_create()
    capi.stream_parse(stream, jpeg_420)
    _, handle = capi.create()
    st = capi.decode(handle, stream, int(OutputFormat.Y), (0, 0, 0, 0),
                     [None, None, None, None], [0, 0, 0, 0])
    assert st == Status.INVALID_PARAMETER


# ----------------------------------------------------------------------
# The real shared library, loaded in-process

@pytest.fixture(scope="module")
def libso():
    r = subprocess.run(["make", "capi"], cwd=REPO, capture_output=True,
                       text=True)
    if r.returncode != 0:
        pytest.skip(f"capi build failed: {r.stderr[-500:]}")
    lib = ctypes.CDLL(os.path.join(REPO, "build", "librocjpeg_tpu.so"))
    lib.rocJpegGetErrorName.restype = ctypes.c_char_p
    lib.rocJpegGetLastError.restype = ctypes.c_char_p
    # Declare pointer argtypes: without them ctypes passes ints (e.g. a
    # c_void_p array element, which reads back as int) as 32-bit, truncating
    # 64-bit handles.
    vp = ctypes.c_void_p
    lib.rocJpegStreamCreate.argtypes = [ctypes.POINTER(vp)]
    lib.rocJpegStreamParse.argtypes = [ctypes.c_void_p, ctypes.c_size_t, vp]
    lib.rocJpegStreamDestroy.argtypes = [vp]
    lib.rocJpegCreate.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(vp)]
    lib.rocJpegDestroy.argtypes = [vp]
    lib.rocJpegGetLastError.argtypes = [vp]
    return lib


class _DecodeParams(ctypes.Structure):
    _fields_ = [("output_format", ctypes.c_int),
                ("left", ctypes.c_int16), ("top", ctypes.c_int16),
                ("right", ctypes.c_int16), ("bottom", ctypes.c_int16),
                ("target_width", ctypes.c_uint32),
                ("target_height", ctypes.c_uint32)]


class _Image(ctypes.Structure):
    _fields_ = [("channel", ctypes.c_void_p * 4),
                ("pitch", ctypes.c_uint32 * 4)]


def test_cabi_error_name(libso):
    assert libso.rocJpegGetErrorName(0) == b"ROCJPEG_STATUS_SUCCESS"
    assert libso.rocJpegGetErrorName(-3) == b"ROCJPEG_STATUS_BAD_JPEG"
    assert libso.rocJpegGetErrorName(99) == b"UNKNOWN_ROCJPEG_STATUS"


def test_cabi_full_decode(libso, jpeg_420):
    handle = ctypes.c_void_p()
    stream = ctypes.c_void_p()
    assert libso.rocJpegCreate(0, 0, ctypes.byref(handle)) == 0
    assert libso.rocJpegStreamCreate(ctypes.byref(stream)) == 0
    buf = (ctypes.c_ubyte * len(jpeg_420)).from_buffer_copy(jpeg_420)
    assert libso.rocJpegStreamParse(buf, len(jpeg_420), stream) == 0

    nc = ctypes.c_uint8()
    css = ctypes.c_int()
    widths = (ctypes.c_uint32 * 4)()
    heights = (ctypes.c_uint32 * 4)()
    assert libso.rocJpegGetImageInfo(handle, stream, ctypes.byref(nc),
                                     ctypes.byref(css), widths, heights) == 0
    assert (nc.value, css.value) == (3, 3)
    assert widths[0] == 128 and heights[0] == 96

    ref = golden.decode(jpeg_420, OutputFormat.RGB)[0][0]
    dest = np.zeros(ref.shape, np.uint8)
    img = _Image()
    img.channel[0] = dest.ctypes.data
    img.pitch[0] = ref.shape[1]
    params = _DecodeParams(output_format=int(OutputFormat.RGB))
    assert libso.rocJpegDecode(handle, stream, ctypes.byref(params),
                               ctypes.byref(img)) == 0
    np.testing.assert_array_equal(dest, ref)

    assert libso.rocJpegStreamDestroy(stream) == 0
    assert libso.rocJpegDestroy(handle) == 0


def test_cabi_decode_batched(libso, jpeg_420):
    n = 3
    handle = ctypes.c_void_p()
    assert libso.rocJpegCreate(0, 0, ctypes.byref(handle)) == 0
    streams = (ctypes.c_void_p * n)()
    bufs = []
    for i in range(n):
        s = ctypes.c_void_p()
        assert libso.rocJpegStreamCreate(ctypes.byref(s)) == 0
        raw = (ctypes.c_ubyte * len(jpeg_420)).from_buffer_copy(jpeg_420)
        assert libso.rocJpegStreamParse(raw, len(jpeg_420), s) == 0
        streams[i] = s
        bufs.append(raw)
    ref = golden.decode(jpeg_420, OutputFormat.Y)[0][0]
    dests = [np.zeros(ref.shape, np.uint8) for _ in range(n)]
    images = (_Image * n)()
    for i in range(n):
        images[i].channel[0] = dests[i].ctypes.data
        images[i].pitch[0] = ref.shape[1]
    params = _DecodeParams(output_format=int(OutputFormat.Y))
    assert libso.rocJpegDecodeBatched(handle, streams, n,
                                      ctypes.byref(params), images) == 0
    for d in dests:
        np.testing.assert_array_equal(d, ref)
    for i in range(n):
        assert libso.rocJpegStreamDestroy(streams[i]) == 0
    assert libso.rocJpegDestroy(handle) == 0


def test_cabi_bad_jpeg_status_and_last_error(libso):
    stream = ctypes.c_void_p()
    assert libso.rocJpegStreamCreate(ctypes.byref(stream)) == 0
    bad = b"\x00\x01not a jpeg"
    buf = (ctypes.c_ubyte * len(bad)).from_buffer_copy(bad)
    assert libso.rocJpegStreamParse(buf, len(bad), stream) == -3  # BAD_JPEG
    assert libso.rocJpegStreamDestroy(stream) == 0


def test_cabi_hybrid_backend_not_implemented(libso):
    handle = ctypes.c_void_p()
    assert libso.rocJpegCreate(1, 0, ctypes.byref(handle)) == -12


# ----------------------------------------------------------------------
# The C sample as a subprocess (the reference's CTest model: exit 0 = pass)

def test_c_sample_subprocess(libso, jpeg_420, tmp_path):
    src = tmp_path / "img.jpg"
    out = tmp_path / "out.raw"
    src.write_bytes(jpeg_420)
    env = dict(os.environ, JAX_PLATFORMS="cpu", ROCJPEG_TPU_ROOT=REPO)
    r = subprocess.run([os.path.join(REPO, "build", "jpegdecode_c"),
                        "-i", str(src), "-fmt", "rgb", "-o", str(out)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = golden.decode(jpeg_420, OutputFormat.RGB)[0][0]
    got = np.fromfile(out, np.uint8)
    np.testing.assert_array_equal(got, ref.reshape(-1))


def test_c_sample_crop(libso, jpeg_420, tmp_path):
    from rocjpeg_tpu.types import CropRectangle
    src = tmp_path / "img.jpg"
    out = tmp_path / "out.raw"
    src.write_bytes(jpeg_420)
    env = dict(os.environ, JAX_PLATFORMS="cpu", ROCJPEG_TPU_ROOT=REPO)
    r = subprocess.run([os.path.join(REPO, "build", "jpegdecode_c"),
                        "-i", str(src), "-fmt", "rgb", "-o", str(out),
                        "-crop", "16,8,80,72"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = golden.decode(jpeg_420, OutputFormat.RGB,
                        CropRectangle(16, 8, 80, 72))[0][0]
    np.testing.assert_array_equal(np.fromfile(out, np.uint8), ref.reshape(-1))
