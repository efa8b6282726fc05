"""Single-image decode CLI — the ``jpegDecode`` sample workload
(samples/jpegDecode/jpegdecode.cpp): loop over a file or directory, parse →
get_image_info → validate/skip → decode (timed) → optional save; print
images/s and Mpixels/s plus skip counters.

Usage: python -m rocjpeg_tpu.tools.jpegdecode -i <file-or-dir> [-fmt rgb] [-o prefix]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import api
from ..status import RocJpegError, Status
from ..types import Backend, ChromaSubsampling as CSS
from . import common


def main(argv=None) -> int:
    args = common.build_arg_parser("Decode JPEG images on the device").parse_args(argv)
    params = common.parse_decode_params(args)
    paths = common.get_file_paths(args.input)
    if not paths:
        print(f"error: no JPEG files found under {args.input}")
        return 1

    decoder = api.Decoder(backend=Backend(args.backend), device_id=args.device)
    stats = common.Stats()
    print(f"info: decoding {len(paths)} image(s), format={args.format}, "
          f"host entropy backend="
          f"{__import__('rocjpeg_tpu.runtime.host_decode', fromlist=['x']).backend_name()}")

    for path in paths:
        try:
            data = open(path, "rb").read()
            stream = api.JpegStream(data)
        except (OSError, RocJpegError):
            stats.skip_bad += 1
            continue
        info = decoder.get_image_info(stream)
        # Same validation/skip logic as jpegdecode.cpp:100-140.
        if info.subsampling == CSS.CSS_411:
            stats.skip_411 += 1
            continue
        if info.subsampling == CSS.CSS_UNKNOWN:
            stats.skip_unknown += 1
            continue
        if info.widths[0] < decoder.spec.min_width or \
                info.heights[0] < decoder.spec.min_height or \
                info.widths[0] > decoder.spec.max_width or \
                info.heights[0] > decoder.spec.max_height:
            stats.skip_resolution += 1
            continue
        try:
            t0 = time.perf_counter()
            image = decoder.decode(stream, params)
            for ch in image.channel:
                if ch is not None and hasattr(ch, "block_until_ready"):
                    ch.block_until_ready()
            t1 = time.perf_counter()
        except RocJpegError as e:
            if e.status == Status.JPEG_NOT_SUPPORTED:
                stats.skip_unknown += 1
                continue
            raise
        stats.decoded += 1
        stats.total_ms += (t1 - t0) * 1000.0
        stats.mpixels += info.widths[0] * info.heights[0] / 1e6
        if args.output:
            name = common.save_image(args.output, path, image, info.widths[0],
                                     info.heights[0], params.output_format,
                                     info.subsampling)
            print(f"info: saved {name}")

    stats.report()
    return 0 if stats.decoded or not paths else 1


if __name__ == "__main__":
    sys.exit(main())
