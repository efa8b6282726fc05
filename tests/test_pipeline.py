"""XLA pipeline tests: the jitted device path must be bit-exact vs the
CPU golden decoder across the output-format matrix, and the session API must
mirror the reference C API semantics."""

import io

import numpy as np
import pytest
from PIL import Image

from rocjpeg_tpu import api
from rocjpeg_tpu.core import golden
from rocjpeg_tpu.core.bitstream import JpegStreamParser
from rocjpeg_tpu.status import RocJpegError, Status
from rocjpeg_tpu.types import (Backend, ChromaSubsampling as CSS,
                               CropRectangle, DecodeParams, OutputFormat)

FORMATS = [OutputFormat.NATIVE, OutputFormat.YUV_PLANAR, OutputFormat.Y,
           OutputFormat.RGB, OutputFormat.RGB_PLANAR]


def _make_jpeg(w=128, h=96, subsampling=2, mode="RGB", seed=0, quality=85):
    rng = np.random.default_rng(seed)
    if mode == "L":
        arr = rng.integers(0, 256, (h, w), np.uint8)
    else:
        arr = rng.integers(0, 256, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", quality=quality,
                                    subsampling=subsampling)
    return buf.getvalue()


# PIL subsampling codes: 0=4:4:4, 1=4:2:2, 2=4:2:0; "L" gives 4:0:0.
CASES = [
    ("444", _make_jpeg(subsampling=0, seed=1)),
    ("422", _make_jpeg(subsampling=1, seed=2)),
    ("420", _make_jpeg(subsampling=2, seed=3)),
    ("400", _make_jpeg(mode="L", seed=4)),
]


@pytest.fixture(scope="module")
def decoder():
    return api.Decoder()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name,data", CASES, ids=[c[0] for c in CASES])
def test_device_bit_exact_vs_golden(decoder, name, data, fmt):
    ref = golden.decode(data, fmt)
    img = decoder.decode(api.JpegStream(data), DecodeParams(output_format=fmt))
    assert len([c for c in img.channel if c is not None]) == len(ref)
    for ci, (ref_arr, ref_pitch) in enumerate(ref):
        assert img.pitch[ci] == ref_pitch
        np.testing.assert_array_equal(np.asarray(img.channel[ci]), ref_arr)


@pytest.mark.parametrize("fmt", FORMATS)
def test_device_crop_bit_exact(decoder, fmt):
    data = _make_jpeg(w=256, h=192, subsampling=2, seed=7)
    crop = CropRectangle(left=32, top=16, right=32 + 128, bottom=16 + 96)
    ref = golden.decode(data, fmt, crop)
    img = decoder.decode(api.JpegStream(data),
                         DecodeParams(output_format=fmt, crop_rectangle=crop))
    for ci, (ref_arr, ref_pitch) in enumerate(ref):
        assert img.pitch[ci] == ref_pitch
        np.testing.assert_array_equal(np.asarray(img.channel[ci]), ref_arr)


def test_decode_batched_mixed_shapes(decoder):
    blobs = [
        _make_jpeg(w=128, h=96, subsampling=2, seed=10),
        _make_jpeg(w=64, h=64, subsampling=0, seed=11),
        _make_jpeg(w=128, h=96, subsampling=2, seed=12),
        _make_jpeg(w=96, h=128, mode="L", seed=13),
        _make_jpeg(w=128, h=96, subsampling=1, seed=14),
    ]
    streams = [api.JpegStream(b) for b in blobs]
    imgs = decoder.decode_batched(streams, DecodeParams(OutputFormat.RGB))
    assert len(imgs) == len(blobs)
    for b, img in zip(blobs, imgs):
        (ref, pitch), = golden.decode(b, OutputFormat.RGB)
        np.testing.assert_array_equal(np.asarray(img.channel[0]), ref)


def test_decode_batched_order_preserved(decoder):
    # Same shape group, different content: results must map back by index.
    blobs = [_make_jpeg(w=64, h=64, subsampling=2, seed=s) for s in range(4)]
    imgs = decoder.decode_batched([api.JpegStream(b) for b in blobs],
                                  DecodeParams(OutputFormat.Y))
    for b, img in zip(blobs, imgs):
        (ref, _), = golden.decode(b, OutputFormat.Y)
        np.testing.assert_array_equal(np.asarray(img.channel[0]), ref)


def test_get_image_info(decoder):
    data = _make_jpeg(w=130, h=94, subsampling=2)
    info = decoder.get_image_info(api.JpegStream(data))
    assert info.num_components == 3
    assert info.subsampling == CSS.CSS_420
    assert info.widths == (130, 65, 65, 0)
    assert info.heights == (94, 47, 47, 0)


def test_get_image_info_400(decoder):
    data = _make_jpeg(mode="L")
    info = decoder.get_image_info(api.JpegStream(data))
    assert info.num_components == 1
    assert info.subsampling == CSS.CSS_400
    assert info.widths[1:] == (0, 0, 0)


def test_hybrid_backend_not_implemented():
    with pytest.raises(RocJpegError) as e:
        api.Decoder(backend=Backend.HYBRID)
    assert e.value.status == Status.NOT_IMPLEMENTED


def test_bad_device_id():
    with pytest.raises(RocJpegError) as e:
        api.Decoder(device_id=1000)
    assert e.value.status == Status.NOT_INITIALIZED


def test_too_small_rejected(decoder):
    # Reference min 64x64 (vaapi_decoder.cpp:290, enforced at :586-592).
    data = _make_jpeg(w=32, h=32, subsampling=2)
    with pytest.raises(RocJpegError) as e:
        decoder.decode(api.JpegStream(data))
    assert e.value.status == Status.JPEG_NOT_SUPPORTED


def test_unparsed_stream_raises(decoder):
    with pytest.raises(RocJpegError):
        decoder.decode(api.JpegStream())


def test_corpus_luma_via_api(decoder, corpus):
    # End-to-end API on a real corpus image vs PIL.
    data = corpus["mug_420"]
    im = Image.open(io.BytesIO(data))
    im.draft("YCbCr", im.size)
    ref_y = np.asarray(im)[:, :, 0]
    img = decoder.decode(api.JpegStream(data), DecodeParams(OutputFormat.Y))
    np.testing.assert_array_equal(np.asarray(img.channel[0]), ref_y)
