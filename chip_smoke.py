"""Smoke test of the decode path on an NVIDIA GPU.

    python chip_smoke.py            # one GPU: phases 1-6 below
    python chip_smoke.py --multi    # four GPUs: the mesh path only

Everything runs in this one process (one process per card). Any failure
raises, so the exit code is non-zero and no result line is printed.

Phases (one GPU):
  1. Device: JAX's first device is a GPU; the card's name and power limit
     (nvidia-smi); the native host library and its index walker loaded.
  2. Compile only: the wave at real widths — headline (16 x 3840x2160
     4:2:0, restart every 4 MCUs) and dri0 (the same size, no restart
     markers: virtual lanes) — with ``compiled.memory_analysis()``.
  3. Wave against reference: the wave's coefficients on the GPU against
     the native host entropy decode, exact; the GPU kernel against the
     plain ``jnp`` wave on the same inputs, exact (coefficients and flags).
  4. End to end through ``api.Decoder().decode_batched`` on four corpora —
     headline (NATIVE), dri0, mixed (4K + 1080p, per-image tables), and
     headline as RGB: only ``wave``/``wave-virtual`` paths, and the first
     and last image of every batch bit-exact on every channel against a
     numpy oracle (native decode_scan, then golden dequant/IDCT/postprocess).
  5. A/B: warm end-to-end Mpix/s of the GPU kernel and of the ``jnp`` wave
     through the same ``decode_batched`` call (medians of ITERS runs).
  6. Last line: {"ok": true, "device": {"platform", "kind", "count"}}.

With --multi: ``MeshDecoder`` over a 4-GPU ``data`` mesh decodes the
headline batch (4 images per card); the output shards must sit on 4
distinct devices and equal the one-card ``Decoder`` output bit for bit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ITERS = 7
W, H, BATCH = 3840, 2160, 16


def card_lines():
    """nvidia-smi's name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def check_device(jax, count=1):
    """Refuse anything but GPUs (at least ``count``); return the devices."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{devs[0].platform!r}, {len(devs)} device(s))")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: {len(devs)} GPU(s), {count} needed")
    return devs


def log(msg):
    print(msg, flush=True)


def corpora():
    import bench
    head = bench.build_corpus(BATCH, W, H, seed=0, ri_mcus=4)
    dri0 = bench.build_corpus(BATCH, W, H, seed=1, ri_mcus=0)
    half = BATCH // 2
    mixed = (bench.build_corpus(half, W, H, seed=2, ri_mcus=4,
                                mixed_tables=True)
             + bench.build_corpus(half, 1920, 1088, seed=3, ri_mcus=4,
                                  mixed_tables=True))
    return {"headline": head, "dri0": dri0, "mixed": mixed}


def pack_group(datas):
    """Host half of one decode group, as decode_group_device_entropy does
    it: (params, tables, packed, geometry, dc_flat, lane_of_mcu)."""
    from rocjpeg_tpu import api
    from rocjpeg_tpu.ops import device_entropy as de
    plist = [api.JpegStream(d).params for d in datas]
    tables, bank_of = de.DeviceScanTables.from_params_banked(plist)
    geom = de.GroupGeometry.from_params(plist[0], len(plist))
    dc_flat = lane_of_mcu = None
    if plist[0].restart_interval == 0:
        packed, dc_flat, lane_of_mcu = de.pack_virtual_segments(
            plist, geom.total_blocks, api.Decoder()._virtual_k(plist),
            bank_of=bank_of)
        lane_of_mcu = lane_of_mcu.copy()
    else:
        packed = de.pack_segments(plist, geom.total_blocks, bank_of=bank_of)
    return plist, tables, packed, geom, dc_flat, lane_of_mcu


def wave_args(tables, packed):
    args = [packed.dense, packed.word_off, packed.img_base,
            packed.mcu_start, packed.mcu_count, tables.lentab, tables.values]
    if tables.n_banks > 1:
        args.append(packed.lane_bank)
    return args


def phase_compile(groups):
    import jax
    from rocjpeg_tpu.ops import device_entropy as de
    for name in ("headline", "dri0"):
        plist, tables, packed, geom, _, _ = groups[name]
        max_steps = de.max_steps_bound(geom, packed)
        t0 = time.perf_counter()
        fn = jax.jit(de.build_wave(geom, packed.n_lanes, packed.n_words,
                                   max_steps, tables.n_banks))
        compiled = fn.lower(*wave_args(tables, packed)).compile()
        log(f"[compile] {name}: wave={de.wave_backend()} "
            f"lanes={packed.n_lanes} n_words={packed.n_words} "
            f"max_steps={max_steps} dense_words={len(packed.dense)} "
            f"compile {time.perf_counter() - t0:.1f}s")
        log(f"[compile] {name}: memory_analysis: "
            f"{compiled.memory_analysis()}")


def coefficient_reference(plist):
    """Native host entropy decode of every image: per image, per component
    (bh, bw, 64) int16 natural-order coefficients."""
    from rocjpeg_tpu.runtime import host_decode
    return host_decode.decode_coefficients_batch(plist)


def phase_wave_vs_reference(groups):
    import numpy as np
    from rocjpeg_tpu.ops import device_entropy as de
    from rocjpeg_tpu.pipeline import _mcu_maps
    for name in ("headline", "dri0", "mixed"):
        plist, tables, packed, _, dc_flat, lane_of_mcu = groups[name]
        outs = {}
        for backend in ("triton", "jnp"):
            with wave_choice(backend):
                coeffs, err, geom = de.decode_coefficients_on_device(
                    plist, tables, packed)
                outs[backend] = (np.asarray(coeffs)[
                    :geom.batch * geom.total_blocks * 64],
                    np.asarray(err))
        assert not outs["triton"][1].any(), f"{name}: wave flagged errors"
        np.testing.assert_array_equal(outs["triton"][0], outs["jnp"][0])
        np.testing.assert_array_equal(outs["triton"][1], outs["jnp"][1])
        comps = de.unflatten_coefficients(outs["triton"][0], geom, None)
        maps = _mcu_maps(geom) if dc_flat is not None else None
        refs = coefficient_reference(plist)
        for i, ref in enumerate(refs):
            for ci, a in enumerate(ref):
                b = np.array(comps[ci][i])
                if maps is not None:
                    b[..., 0] += dc_flat[lane_of_mcu[i][maps[ci]], ci]
                np.testing.assert_array_equal(a, b[:a.shape[0], :a.shape[1]])
        log(f"[wave] {name}: {len(plist)} images, kernel == jnp wave == "
            f"native host decode (banks={tables.n_banks}, "
            f"lanes={packed.n_lanes})")


class wave_choice:
    """Pin device_entropy.wave_backend() to one wave inside the block."""

    def __init__(self, backend):
        self.backend = backend

    def __enter__(self):
        from rocjpeg_tpu.ops import device_entropy as de
        self._saved = de.wave_backend
        de.wave_backend = lambda: self.backend

    def __exit__(self, *exc):
        from rocjpeg_tpu.ops import device_entropy as de
        de.wave_backend = self._saved


def oracle(data, fmt):
    """Numpy oracle: native entropy decode, golden dequant/IDCT/layout."""
    import numpy as np
    from rocjpeg_tpu import api
    from rocjpeg_tpu.core import golden
    from rocjpeg_tpu.ops import postprocess
    from rocjpeg_tpu.runtime import native
    p = api.JpegStream(data).params
    planes = golden.planes_from_coefficients(p, native.decode_scan(p))
    return postprocess.render_output(np, p.chroma_subsampling, planes,
                                     p.picture_width, p.picture_height, fmt,
                                     None)


def block(imgs):
    for img in imgs:
        for ch in img.channel:
            if ch is not None:
                ch.block_until_ready()


E2E = (("headline", "headline", "NATIVE"), ("dri0", "dri0", "NATIVE"),
       ("mixed", "mixed", "NATIVE"), ("rgb", "headline", "RGB"))


def phase_end_to_end(corp):
    import numpy as np
    from rocjpeg_tpu import api
    from rocjpeg_tpu.types import DecodeParams, OutputFormat
    dec = api.Decoder()
    for leg, cname, fmt_name in E2E:
        datas = corp[cname]
        fmt = OutputFormat[fmt_name]
        streams = [api.JpegStream(d) for d in datas]
        t0 = time.perf_counter()
        imgs = dec.decode_batched(streams, DecodeParams(fmt))
        block(imgs)
        first = time.perf_counter() - t0
        paths = sorted({p for p, _ in dec.last_paths})
        assert set(paths) <= {"wave", "wave-virtual"}, (leg, paths)
        # Groups: every (shape) group's first and last image.
        groups = {}
        for i, d in enumerate(datas):
            p = streams[i].params
            groups.setdefault((p.picture_width, p.picture_height), []).append(i)
        checked = sorted({i for g in groups.values() for i in (g[0], g[-1])})
        for i in checked:
            ref = oracle(datas[i], fmt)
            assert len(ref) == sum(c is not None for c in imgs[i].channel)
            for ci, (arr, pitch) in enumerate(ref):
                assert imgs[i].pitch[ci] == pitch, (leg, i, ci)
                np.testing.assert_array_equal(np.asarray(imgs[i].channel[ci]),
                                              arr, err_msg=f"{leg} img {i}")
        log(f"[e2e] {leg}: {len(datas)} images, paths {paths}, images "
            f"{checked} bit-exact on every channel; first call "
            f"{first:.1f}s")


def timed_mpix(dec, streams, params, mpix):
    """Median Mpix/s over ITERS warm decode_batched calls (each ends in
    block_until_ready on every output)."""
    import numpy as np
    block(dec.decode_batched(streams, params))  # warm (compile)
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        block(dec.decode_batched(streams, params))
        times.append(time.perf_counter() - t0)
    for e in dec.last_error_flags:
        assert not bool(np.asarray(e).any())
    return mpix / float(np.median(times)), times


def phase_ab(corp, card):
    from rocjpeg_tpu import api
    from rocjpeg_tpu.types import DecodeParams, OutputFormat
    dec = api.Decoder(check_errors=False)
    results = {}
    for leg, cname, fmt_name in E2E:
        datas = corp[cname]
        streams = [api.JpegStream(d) for d in datas]
        mpix = sum(s.params.picture_width * s.params.picture_height
                   for s in streams) / 1e6
        params = DecodeParams(OutputFormat[fmt_name])
        row = {}
        for backend in ("triton", "jnp", "triton"):
            with wave_choice(backend):
                rate, times = timed_mpix(dec, streams, params, mpix)
            row.setdefault(backend, []).append(rate)
            log(f"[ab] {leg} wave={backend}: {rate:.1f} Mpix/s "
                f"(median of {ITERS}; times "
                f"{[round(t * 1e3, 1) for t in times]} ms)")
        results[leg] = row
    log(f"[ab] card: {card}")
    log("[ab] " + json.dumps(results))


def run_single():
    import jax
    devs = check_device(jax)
    card = card_lines()
    log(f"[device] platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)} host_cores={os.cpu_count()}")
    log("[device] card (nvidia-smi name, power limit):")
    log(card)
    from rocjpeg_tpu.runtime import host_decode, native
    host_decode.require_native()
    log(f"[device] native host library loaded; index walker ok; AVX-512 "
        f"walk={bool(native.index_scan16_available())}")

    t0 = time.perf_counter()
    corp = corpora()
    log(f"[corpus] built in {time.perf_counter() - t0:.1f}s: "
        + ", ".join(f"{k}={len(v)} imgs "
                    f"{sum(map(len, v)) / len(v) / 1024:.0f} KiB avg"
                    for k, v in corp.items()))
    # Wave groups at real widths; "mixed" is its banked 4K shape group.
    groups = {"headline": pack_group(corp["headline"]),
              "dri0": pack_group(corp["dri0"]),
              "mixed": pack_group(corp["mixed"][:BATCH // 2])}

    phase_compile(groups)
    phase_wave_vs_reference(groups)
    phase_end_to_end(corp)
    phase_ab(corp, card)
    return devs


def run_multi():
    import jax
    import numpy as np
    devs = check_device(jax, 4)[:4]
    card = card_lines()
    log(f"[device] platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)} host_cores={os.cpu_count()}")
    log("[device] cards (nvidia-smi name, power limit):")
    log(card)
    import bench
    from jax.sharding import Mesh
    from rocjpeg_tpu import api
    from rocjpeg_tpu.dist import sharding
    from rocjpeg_tpu.types import DecodeParams, OutputFormat
    datas = bench.build_corpus(BATCH, W, H, seed=0, ri_mcus=4)
    streams = [api.JpegStream(d) for d in datas]
    params = DecodeParams(OutputFormat.NATIVE)
    mesh = Mesh(np.array(devs).reshape(4, 1), ("data", "space"))
    md = sharding.MeshDecoder(mesh=mesh)
    t0 = time.perf_counter()
    got = md.decode_batched(streams, params)
    block(got)
    log(f"[multi] mesh decode of {len(datas)} images: "
        f"{time.perf_counter() - t0:.1f}s (first call)")
    # The batch array behind image 0's first channel (LazyChannel).
    shard_devs = set(got[0].channel[0]._batch.devices())
    assert len(shard_devs) == 4, shard_devs
    for e in md.last_error_flags:
        assert not bool(np.asarray(e).any())
    ref = api.Decoder().decode_batched(streams, params)
    for i, (a, b) in enumerate(zip(got, ref)):
        for ci in range(len(b.channel)):
            if b.channel[ci] is None:
                assert a.channel[ci] is None
                continue
            assert a.pitch[ci] == b.pitch[ci]
            np.testing.assert_array_equal(np.asarray(a.channel[ci]),
                                          np.asarray(b.channel[ci]),
                                          err_msg=f"image {i} channel {ci}")
    log(f"[multi] output shards on {len(shard_devs)} devices; "
        f"{len(datas)} images bit-exact against the one-card Decoder")
    return devs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU mesh path")
    args = ap.parse_args(argv)
    devs = run_multi() if args.multi else run_single()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
