"""Batched decode CLI — the ``jpegDecodeBatched`` sample workload
(samples/jpegDecodeBatched/jpegdecodebatched.cpp): same pipeline but decoding
``-b`` streams per ``decode_batched`` call, compacting valid images into each
batch (:183-188) and timing the batched call.

Usage: python -m rocjpeg_tpu.tools.jpegdecodebatched -i <dir> -b 8 [-fmt rgb]
"""

from __future__ import annotations

import sys
import time

from .. import api
from ..status import RocJpegError, Status
from ..types import Backend, ChromaSubsampling as CSS
from . import common


def main(argv=None) -> int:
    args = common.build_arg_parser("Batched JPEG decode on the device",
                                   batched=True).parse_args(argv)
    params = common.parse_decode_params(args)
    paths = common.get_file_paths(args.input)
    if not paths:
        print(f"error: no JPEG files found under {args.input}")
        return 1

    decoder = api.Decoder(backend=Backend(args.backend), device_id=args.device)
    stats = common.Stats()

    for start in range(0, len(paths), args.batch_size):
        chunk = paths[start:start + args.batch_size]
        streams, metas = [], []
        for path in chunk:
            # Compact valid images into the batch (jpegdecodebatched.cpp:183-188).
            try:
                stream = api.JpegStream(open(path, "rb").read())
            except (OSError, RocJpegError):
                stats.skip_bad += 1
                continue
            info = decoder.get_image_info(stream)
            if info.subsampling == CSS.CSS_411:
                stats.skip_411 += 1
                continue
            if info.subsampling == CSS.CSS_UNKNOWN:
                stats.skip_unknown += 1
                continue
            if not (decoder.spec.min_width <= info.widths[0] <= decoder.spec.max_width
                    and decoder.spec.min_height <= info.heights[0]
                    <= decoder.spec.max_height):
                stats.skip_resolution += 1
                continue
            streams.append(stream)
            metas.append((path, info))
        if not streams:
            continue
        t0 = time.perf_counter()
        images = decoder.decode_batched(streams, params)
        for img in images:
            for ch in img.channel:
                if ch is not None and hasattr(ch, "block_until_ready"):
                    ch.block_until_ready()
        t1 = time.perf_counter()
        stats.decoded += len(images)
        stats.total_ms += (t1 - t0) * 1000.0
        stats.mpixels += sum(i.widths[0] * i.heights[0] for _, i in metas) / 1e6
        if args.output:
            for (path, info), img in zip(metas, images):
                common.save_image(args.output, path, img, info.widths[0],
                                  info.heights[0], params.output_format,
                                  info.subsampling)

    stats.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
