"""Benchmark: batched JPEG decode throughput on one GPU.

Measures the end-to-end decode path (compressed bytes in host memory to
decoded planes on the device, after block_until_ready) over four corpora:

1. HEADLINE — synthesized photo-like 4K 4:2:0 with per-4-MCU restart
   intervals (BASELINE.json "jpegDecodeBatched: batch-sharded on one host").
2. DRI=0 — the same size with NO restart markers, the realistic workload
   (the reference's own data/images carry none). Rides the wave via
   virtual restart points (host index pass, ops/device_entropy.py
   pack_virtual_segments); the index walk runs every iteration — nothing
   is cached across decodes beyond the parsed header, matching the
   reference's jpegdecodeperf lifecycle (jpegdecodeperf.cpp:75-182).
3. MIXED — two resolutions (4K + 1080p, two shape groups per call) with
   per-image Huffman tables (exercises the banked wave + per-group
   programs; the JpegStreamKey-grouping analog, vaapi_decoder.cpp:694-834).
4. RGB — the headline corpus delivered as packed RGB (the reference's
   marquee output path; records the fused color-convert epilogue cost).

Each leg runs in its own process (one process per card; the parent never
imports JAX) and fails unless JAX's first device is a GPU. Diagnostics go
to stderr; stdout carries the device lines (platform, device kind, device
count, host cores, and nvidia-smi's name and power limit) and then ONE
JSON line. Synthesized corpora are cached inside the checkout
(.corpus_cache/).
"""

import json
import os
import sys
import time

import numpy as np


def _smooth_plane(rng, h, w, detail=8):
    """Photo-like content: low-frequency base + mild noise (keeps the
    entropy-coded symbol rate realistic, unlike white noise)."""
    base = rng.integers(0, 256, (h // detail + 1, w // detail + 1)).astype(np.float32)
    up = np.kron(base, np.ones((detail, detail), np.float32))[:h, :w]
    noise = rng.normal(0, 6, (h, w)).astype(np.float32)
    return np.clip(up + noise, 0, 255).astype(np.uint8)


def _encode(job):
    """Encode one synthesized image (a process-pool task)."""
    from rocjpeg_tpu.testing import encoder
    planes, ri_mcus, variant = job
    return encoder.encode_planes(planes, "420", restart_interval=ri_mcus,
                                 table_variant=variant)


def build_corpus(n_images, w, h, seed=0, ri_mcus=None, mixed_tables=False):
    """Synthesize (or load from the disk cache) one bench corpus.

    Corpora are pure functions of the arguments, so they are cached inside
    the checkout (BENCH_CORPUS_CACHE, default .corpus_cache/) keyed by the
    full parameter tuple. Images are encoded in parallel worker processes
    (the encoder is numpy; ~3 s per 4K image on one core)."""
    if ri_mcus is None:
        ri_mcus = (w + 15) // 16  # one MCU row per restart segment
    cache_dir = os.environ.get("BENCH_CORPUS_CACHE") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".corpus_cache")
    key = f"v1_n{n_images}_w{w}_h{h}_s{seed}_ri{ri_mcus}_mt{int(mixed_tables)}"
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return [z[f"d{i}"].tobytes() for i in range(n_images)]

    import concurrent.futures
    import multiprocessing
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n_images):
        planes = [_smooth_plane(rng, h, w),
                  _smooth_plane(rng, h // 2, w // 2),
                  _smooth_plane(rng, h // 2, w // 2)]
        jobs.append((planes, ri_mcus, (i % 2) if mixed_tables else 0))
    workers = max(1, min(len(jobs), os.cpu_count() or 1))
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        datas = list(pool.map(_encode, jobs))

    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"  # .npz suffix: savez appends it
    np.savez(tmp, **{f"d{i}": np.frombuffer(d, np.uint8)
                     for i, d in enumerate(datas)})
    os.replace(tmp, path)
    return datas


def run_config(name, decoder, datas, params, iters, n_threads, w=None, h=None,
               mpix_iter=None, reps=None):
    """Measure one corpus: returns Mpix/s. Streams are parsed once (cheap
    header parse, the reference's handle model); all entropy/index work
    runs per decode call. mpix_iter overrides the uniform w*h*n pixel
    count for mixed-shape corpora.

    The measurement loop runs `reps` times (env BENCH_REPS, default 1) and
    the MEDIAN rep is reported."""
    from rocjpeg_tpu import api

    n_images = len(datas)
    streams = [api.JpegStream(d) for d in datas]
    if mpix_iter is None:
        mpix_iter = n_images * w * h / 1e6
    if reps is None:
        reps = int(os.environ.get("BENCH_REPS", "1"))

    # Warmup (jit compile + caches).
    imgs = decoder.decode_batched(streams, params)
    for img in imgs:
        for ch in img.channel:
            if ch is not None and hasattr(ch, "block_until_ready"):
                ch.block_until_ready()
    # Entropy-path visibility: every recorded number names the path that
    # served each chunk.
    path_counts = {}
    for p, idxs in decoder.last_paths:
        path_counts[p] = path_counts.get(p, 0) + len(idxs)
    print(f"[{name}] warmup done; entropy paths (imgs): {path_counts}",
          file=sys.stderr)

    lasts = [None] * max(1, n_threads)

    def worker(tid, count):
        # Depth-2 pipeline: dispatch batch i, then block on batch i-1 —
        # at most two batches in flight, overlapping host work of the
        # current batch with device compute of the previous one.
        import collections
        inflight = collections.deque()
        out = None
        for _ in range(count):
            out = decoder.decode_batched(streams, params)
            inflight.append(out)
            if len(inflight) > 1:
                old = inflight.popleft()
                old[0].channel[0].block_until_ready()
        lasts[tid] = out

    results = []
    for rep in range(reps):
        t0 = time.perf_counter()
        if n_threads <= 1:
            worker(0, iters)
        else:
            import threading
            per = [iters // n_threads + (1 if t < iters % n_threads else 0)
                   for t in range(n_threads)]
            ts = [threading.Thread(target=worker, args=(t, per[t]))
                  for t in range(n_threads)]
            for th in ts:
                th.start()
            for th in ts:
                th.join()
        for last in lasts:
            for img in last or []:
                for ch in img.channel:
                    if ch is not None and hasattr(ch, "block_until_ready"):
                        ch.block_until_ready()
        t1 = time.perf_counter()

        for e in decoder.last_error_flags:
            assert not bool(np.asarray(e).any()), \
                "decode error flagged in bench"

        elapsed = t1 - t0
        mpix_s = iters * mpix_iter / elapsed
        print(f"[{name}] rep {rep + 1}/{reps}: {iters} iters x {n_images} "
              f"images in {elapsed:.2f}s "
              f"({iters * n_images / elapsed:.1f} img/s, "
              f"{mpix_s:.1f} Mpix/s)", file=sys.stderr)
        results.append(mpix_s)

    med = float(np.median(results))
    print(f"[{name}] median of {reps}: {med:.1f} Mpix/s "
          f"(min {min(results):.1f}, max {max(results):.1f})",
          file=sys.stderr)
    decoder.synchronize()
    return med


def run_leg_subprocess(leg: str, reps: int = None):
    """Run one bench leg in fresh Python processes (one at a time); return
    (median Mpix/s, the device record of the first run)."""
    import subprocess
    if reps is None:
        reps = int(os.environ.get("BENCH_REPS", "3"))
    env = dict(os.environ)
    env["BENCH_LEG"] = leg
    env["BENCH_REPS"] = "1"  # one in-process measurement per child
    values = []
    device = None
    for rep in range(reps):
        out = subprocess.run([sys.executable, os.path.abspath(__file__)],
                             env=env, capture_output=True, text=True,
                             timeout=int(os.environ.get("BENCH_REP_TIMEOUT",
                                                        "900")))
        sys.stderr.write(out.stderr)
        got = None
        for line in out.stdout.splitlines():
            line = line.strip()
            if line.startswith("{"):
                got = json.loads(line)
        if out.returncode != 0 or got is None:
            raise RuntimeError(f"bench leg {leg} rep {rep} failed "
                               f"(exit {out.returncode})")
        values.append(float(got["value"]))
        device = device or got["device"]
    med = float(np.median(values))
    print(f"[{leg}] median of {reps} runs: {med:.1f} Mpix/s "
          f"(all: {[round(v, 1) for v in values]})", file=sys.stderr)
    return med, device


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards (one per line)."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def main():
    # Headline config: batches of 4K (3840x2160) images — the resolution of
    # the reference's bundled corpus (data/images/mug_*.jpg).
    n_images = int(os.environ.get("BENCH_BATCH", "16"))
    w = int(os.environ.get("BENCH_W", "3840"))
    h = int(os.environ.get("BENCH_H", "2160"))
    iters = int(os.environ.get("BENCH_ITERS", "16"))
    fmt_name = os.environ.get("BENCH_FMT", "native")
    ri_mcus = int(os.environ.get("BENCH_RI_MCUS", "4"))
    entropy_mode = os.environ.get("BENCH_ENTROPY", "auto")
    # Host threads submitting batches concurrently (the jpegDecodePerf
    # model, samples/jpegDecodePerf/jpegdecodeperf.cpp:228-258). The
    # defaults (3 on the DRI=0 leg, 4 elsewhere) are untuned on this host
    # (ROADMAP A3).
    leg = os.environ.get("BENCH_LEG")
    default_threads = "3" if leg == "dri0" else "4"
    n_threads = int(os.environ.get("BENCH_THREADS", default_threads))
    # Extra legs can be skipped for quick iteration.
    run_extras = os.environ.get("BENCH_EXTRAS", "1") != "0"

    if leg is None:
        # Orchestrator: one subprocess per leg, one at a time.
        result = {}
        device = None
        for name, key in (("headline", "value"), ("dri0", "dri0_mpix_s"),
                          ("mixed", "mixed_mpix_s"), ("rgb", "rgb_mpix_s")):
            if name != "headline" and not run_extras:
                continue
            value, dev = run_leg_subprocess(name)
            device = device or dev
            result[key] = round(value, 1)
        result = {"metric": "Mpixels/sec batched 4:2:0 decode",
                  "unit": "Mpixel/s", **result, "device": device}
        print(f"platform={device['platform']} kind={device['kind']} "
              f"count={device['count']} host_cores={device['host_cores']}")
        print(device["card"])
        print(json.dumps(result))
        return

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX platform {devs[0].platform!r})")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs), "host_cores": os.cpu_count(),
              "card": card_line()}

    t0 = time.time()
    mpix_iter = None
    if leg == "headline":
        datas = build_corpus(n_images, w, h, ri_mcus=ri_mcus)
    elif leg == "rgb":
        # Headline corpus delivered as packed RGB — the reference's marquee
        # output path (13 HIP kernels, rocjpeg_hip_kernels.cpp:238-2070).
        # Records the fused color-convert epilogue's cost, which the
        # native-format legs cannot see.
        datas = build_corpus(n_images, w, h, ri_mcus=ri_mcus)
        fmt_name = "rgb"
    elif leg == "dri0":
        datas = build_corpus(n_images, w, h, seed=1, ri_mcus=0)
    elif leg == "mixed":
        # Bench realism: two resolutions (two shape groups, two compiled
        # programs per call) AND per-image Huffman tables (banked wave —
        # groups key on shape alone). The reference analog is the
        # JpegStreamKey grouping in vaapi_decoder.cpp:694-834 with
        # per-image DHT forwarding.
        half = n_images // 2
        datas = (build_corpus(half, w, h, seed=2, ri_mcus=ri_mcus,
                              mixed_tables=True)
                 + build_corpus(half, 1920, 1088, seed=3, ri_mcus=ri_mcus,
                                mixed_tables=True))
        mpix_iter = (half * w * h + half * 1920 * 1088) / 1e6
    else:
        raise SystemExit(f"unknown BENCH_LEG {leg!r}")
    if mpix_iter is None:
        mpix_iter = len(datas) * w * h / 1e6
    print(f"[{leg}] corpus: {len(datas)} imgs, {mpix_iter:.1f} Mpix/iter "
          f"4:2:0, avg {sum(map(len, datas))/len(datas)/1024:.0f} KiB, "
          f"built in {time.time()-t0:.1f}s", file=sys.stderr)

    from rocjpeg_tpu import api
    from rocjpeg_tpu.runtime import host_decode
    from rocjpeg_tpu.tools.common import FMT_NAMES
    from rocjpeg_tpu.types import DecodeParams

    params = DecodeParams(output_format=FMT_NAMES[fmt_name])
    # check_errors=False: no host<->device sync inside the decode loop; the
    # error flags stay on device and are verified once after timing.
    decoder = api.Decoder(device_entropy=entropy_mode, check_errors=False)
    print(f"host entropy backend: {host_decode.backend_name()}; "
          f"device_entropy={entropy_mode}", file=sys.stderr)

    value = run_config(leg, decoder, datas, params, iters, n_threads,
                       mpix_iter=mpix_iter)
    print(json.dumps({
        "metric": f"Mpixels/sec batched 4:2:0 decode ({leg})",
        "value": round(value, 1),
        "unit": "Mpixel/s",
        "device": device,
    }))


if __name__ == "__main__":
    main()
