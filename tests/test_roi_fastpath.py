"""ROI fast path: crops decode only the ROI-intersecting restart segments.

The reference decodes only the crop in hardware on MI300
(vaapi_decoder.cpp:640-658); the wave analog packs only the segments whose
MCU rows intersect the crop — real restart segments (byte stuffing is
context-free, DC resets at RSTn) and virtual ones (the index pass knows
every lane's geometry) both support it. Pixels outside the packed band
never reach the link or the wave; the layout stage slices the crop as
before, so results stay bit-exact vs the golden full decode's crop.
"""

import numpy as np
import pytest

from rocjpeg_tpu import api
from rocjpeg_tpu.core import golden
from rocjpeg_tpu.core.bitstream import JpegStreamParser
from rocjpeg_tpu.ops import device_entropy as de
from rocjpeg_tpu.testing import encoder
from rocjpeg_tpu.types import CropRectangle, DecodeParams, OutputFormat


def _blob(css, w, h, ri, seed=3):
    return encoder.encode_planes(encoder.random_planes(css, w, h, seed=seed),
                                 css, restart_interval=ri)


@pytest.mark.parametrize("ri", [2, 0])
@pytest.mark.parametrize("fmt", [OutputFormat.RGB, OutputFormat.NATIVE])
def test_roi_crop_bit_exact_device_entropy(ri, fmt):
    """Cropped device-entropy decode (real restarts and virtual ones) must
    equal the golden full-frame decode's crop."""
    blob = _blob("420", 192, 160, ri)
    crop = CropRectangle(16, 48, 16 + 96, 48 + 64)  # rows 3..7 of 10
    dec = api.Decoder(device_entropy="on")
    img = dec.decode(api.JpegStream(blob), DecodeParams(fmt, crop))
    ref = golden.decode(blob, fmt, crop)
    for got, (want, _p) in zip([c for c in img.channel if c is not None],
                               ref):
        np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("ri", [2, 0])
def test_roi_packs_only_intersecting_lanes(ri):
    """The pack must shrink with the crop: lanes outside the ROI rows
    carry no payload."""
    blob = _blob("420", 192, 160, ri)
    p = JpegStreamParser().parse(blob)
    geom = de.GroupGeometry.from_params(p, 1)
    full_range = None
    roi_range = (3 * p.mcus_per_row, 7 * p.mcus_per_row)  # rows 3..7 of 10
    if ri:
        full = de.pack_segments([p], geom.total_blocks)
        part = de.pack_segments([p], geom.total_blocks,
                                mcu_range=roi_range)
    else:
        full, _, _ = de.pack_virtual_segments([p], geom.total_blocks, 60,
                                              mcu_range=full_range)
        part, _, _ = de.pack_virtual_segments([p], geom.total_blocks, 60,
                                              mcu_range=roi_range)
    assert part.total_bytes <= full.total_bytes
    # Active lanes must cover only the selected band (plus at most one
    # leading lane that straddles the lower edge).
    act = part.mcu_count > 0
    assert part.mcu_start[act].min() <= roi_range[0]
    assert (part.mcu_start[act] + part.mcu_count[act]).max() <= (
        roi_range[1] if ri else p.num_mcus)
    assert act.sum() < (full.mcu_count > 0).sum()


def test_roi_odd_band_and_edges():
    """Crops touching the first and last MCU rows, odd offsets."""
    blob = _blob("420", 160, 128, 1)
    dec = api.Decoder(device_entropy="on")
    for crop in (CropRectangle(0, 0, 64, 32),        # top band
                 CropRectangle(5, 97, 80, 128),      # bottom band, odd top
                 CropRectangle(3, 17, 160, 113)):    # interior, odd coords
        img = dec.decode(api.JpegStream(blob),
                         DecodeParams(OutputFormat.Y, crop))
        (ref, _), = golden.decode(blob, OutputFormat.Y, crop)
        np.testing.assert_array_equal(np.asarray(img.channel[0]), ref)


def test_roi_batch_mixed_with_full_decode():
    """A cropped batched decode followed by a full decode of the same
    streams (different jit keys) both stay exact."""
    blobs = [_blob("420", 192, 160, 2, seed=s) for s in range(3)]
    dec = api.Decoder(device_entropy="on")
    crop = CropRectangle(32, 64, 32 + 64, 64 + 64)
    streams = [api.JpegStream(b) for b in blobs]
    imgs = dec.decode_batched(streams, DecodeParams(OutputFormat.Y, crop))
    for b, img in zip(blobs, imgs):
        (ref, _), = golden.decode(b, OutputFormat.Y, crop)
        np.testing.assert_array_equal(np.asarray(img.channel[0]), ref)
    imgs = dec.decode_batched(streams, DecodeParams(OutputFormat.Y))
    for b, img in zip(blobs, imgs):
        (ref, _), = golden.decode(b, OutputFormat.Y)
        np.testing.assert_array_equal(np.asarray(img.channel[0]), ref)
