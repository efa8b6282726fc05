"""Throughput harness — the ``jpegDecodePerf`` sample workload
(samples/jpegDecodePerf/jpegdecodeperf.cpp): ``-t`` pipeline threads x ``-b``
batch size over a corpus, files partitioned across threads (:245-252),
aggregated images/s and Mpixels/s (:260-300).

On the device path the threads overlap host-side parse+entropy with device compute
(the reference's rationale — one serialized handle per thread — maps to one
shared XLA stream fed by several host threads). A ``--mesh`` flag shards
each batch across all local devices via the dist layer (pod-scale analog).

Usage: python -m rocjpeg_tpu.tools.jpegdecodeperf -i <dir> -t 2 -b 32 [--mesh]
"""

from __future__ import annotations

import concurrent.futures
import sys
import threading
import time

from .. import api
from ..status import RocJpegError
from ..types import Backend, ChromaSubsampling as CSS
from . import common


def _decode_worker(decoder, paths, params, batch_size, stats, lock):
    local_decoded = 0
    local_mpix = 0.0
    for start in range(0, len(paths), batch_size):
        chunk = paths[start:start + batch_size]
        streams, mpix = [], 0.0
        for path in chunk:
            try:
                stream = api.JpegStream(open(path, "rb").read())
            except (OSError, RocJpegError):
                with lock:
                    stats.skip_bad += 1
                continue
            info = decoder.get_image_info(stream)
            if info.subsampling in (CSS.CSS_411, CSS.CSS_UNKNOWN):
                with lock:
                    stats.skip_unknown += 1
                continue
            streams.append(stream)
            mpix += info.widths[0] * info.heights[0] / 1e6
        if not streams:
            continue
        images = decoder.decode_batched(streams, params)
        for img in images:
            for ch in img.channel:
                if ch is not None and hasattr(ch, "block_until_ready"):
                    ch.block_until_ready()
        local_decoded += len(images)
        local_mpix += mpix
    with lock:
        stats.decoded += local_decoded
        stats.mpixels += local_mpix


def main(argv=None) -> int:
    ap = common.build_arg_parser("JPEG decode throughput harness",
                                 threaded=True)
    ap.add_argument("--mesh", action="store_true",
                    help="shard batches across all local devices")
    ap.add_argument("--warmup", type=int, default=1,
                    help="warmup passes before timing")
    args = ap.parse_args(argv)
    params = common.parse_decode_params(args)
    paths = common.get_file_paths(args.input)
    if not paths:
        print(f"error: no JPEG files found under {args.input}")
        return 1
    nthreads = max(1, min(args.threads, 32))  # cap like samples_utils.h:153

    # One decoder handle per thread — the reference's model
    # (jpegdecodeperf.cpp:228-241): a handle's in-flight throttle is
    # per-handle state, so sharing one across threads serializes the
    # pipeline at its depth-2 queue.
    if args.mesh:
        from ..dist import sharding
        decoders = [sharding.MeshDecoder() for _ in range(nthreads)]
    else:
        decoders = [api.Decoder(backend=Backend(args.backend),
                                device_id=args.device)
                    for _ in range(nthreads)]
    stats = common.Stats()
    lock = threading.Lock()

    # Partition files across threads (jpegdecodeperf.cpp:245-252).
    shards = [paths[i::nthreads] for i in range(nthreads)]

    # Warm up EVERY shard so each thread's shapes are jit-compiled before
    # the timed region (compiles are global across decoders, but each
    # shard may contain shapes the others don't).
    for _ in range(args.warmup):
        with concurrent.futures.ThreadPoolExecutor(nthreads) as pool:
            futs = [pool.submit(_decode_worker, dec, shard[:args.batch_size],
                                params, args.batch_size, common.Stats(), lock)
                    for dec, shard in zip(decoders, shards) if shard]
            for f in futs:
                f.result()

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(nthreads) as pool:
        futs = [pool.submit(_decode_worker, dec, shard, params,
                            args.batch_size, stats, lock)
                for dec, shard in zip(decoders, shards) if shard]
        for f in futs:
            f.result()
    t1 = time.perf_counter()

    elapsed = t1 - t0
    stats.total_ms = elapsed * 1000.0
    print(f"info: threads={nthreads} batch={args.batch_size} "
          f"files={len(paths)} elapsed={elapsed:.3f}s")
    if stats.decoded:
        print(f"info: total decoded images: {stats.decoded}")
        print(f"info: avg images per sec: {stats.decoded / elapsed:.4f}")
        print(f"info: avg decoded data size (Mpixels/sec): "
              f"{stats.mpixels / elapsed:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
