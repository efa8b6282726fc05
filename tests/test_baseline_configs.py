"""Scaled-down versions of the driver's BASELINE.json configs that aren't
already covered one-for-one elsewhere:

  3. restart-interval-parallel Huffman decode of ONE large image across
     the chip (all wave lanes from a single stream);
  4. jpegDecodeBatched over a mixed-resolution batch (shape-group
     dispatch, order preserved).

(1-2 live in test_golden/test_formats/test_tools against the reference
corpus; 5 in test_multihost.)"""

import numpy as np

from rocjpeg_tpu import api
from rocjpeg_tpu.core import golden
from rocjpeg_tpu.testing import encoder
from rocjpeg_tpu.types import DecodeParams, OutputFormat


def test_single_large_image_wave_decode():
    # One 512x384 4:2:0 stream, DRI = 2 MCUs -> 384 restart segments: a
    # single image fans out over the whole wave.
    planes = encoder.random_planes("420", 512, 384, seed=7)
    blob = encoder.encode_planes(planes, "420", restart_interval=2)
    dec = api.Decoder(device_entropy="on", check_errors=True)
    img = dec.decode(api.JpegStream(blob), DecodeParams(OutputFormat.RGB))
    (ref, _), = golden.decode(blob, OutputFormat.RGB)
    np.testing.assert_array_equal(np.asarray(img.channel[0]), ref)


def test_mixed_resolution_batched_decode():
    sizes = [(96, 64), (128, 96), (160, 128)]
    blobs = []
    for i in range(9):
        w, h = sizes[i % len(sizes)]
        blobs.append(encoder.encode_planes(
            encoder.random_planes("420", w, h, seed=i), "420",
            restart_interval=4))
    dec = api.Decoder(device_entropy="on")
    imgs = dec.decode_batched([api.JpegStream(b) for b in blobs],
                              DecodeParams(OutputFormat.Y))
    assert len(imgs) == len(blobs)
    for b, img in zip(blobs, imgs):
        (ref, _), = golden.decode(b, OutputFormat.Y)
        np.testing.assert_array_equal(np.asarray(img.channel[0]), ref)


def test_spec_for_device_table():
    """Per-platform capability lookup (the VcnJpegSpec-table analog,
    reference vaapi_decoder.cpp:294-305): one row per platform, named after
    the device kind."""
    import jax
    from rocjpeg_tpu import api
    from rocjpeg_tpu.types import spec_for_device

    spec = spec_for_device(jax.devices()[0])  # cpu under tests
    assert spec.name == "cpu" and spec.num_decode_lanes == 8

    class FakeDev:
        device_kind = "NVIDIA H100 80GB HBM3"
        platform = "gpu"

    s = spec_for_device(FakeDev())
    assert s.name == "NVIDIA H100 80GB HBM3" and s.num_decode_lanes == 32
    assert s.can_convert_to_rgb and s.can_roi_decode
    assert (s.max_width, s.max_height) == (16384, 16384)
    # Decoder picks up the device spec automatically.
    assert api.Decoder().spec.name == "cpu"
