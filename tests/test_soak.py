"""Volume soak: a time-boxed sweep of generator-varied hostile and clean
images through the DEFAULT decode path, asserting typed-error-or-bit-exact
for every single input (the volume pass behind the per-file fuzz suites
in test_fuzz.py / test_native_fuzz.py).

Every iteration draws a fresh configuration (chroma subsampling, odd
dimensions, restart interval incl. DRI=0, table variant, optimized tables)
and a mutation (none / truncation / bit flips / embedded marker), then:

  - clean images decode through ``Decoder.decode_batched`` and must be
    BIT-EXACT against the pure-Python golden oracle;
  - mutated images must either decode or raise ``RocJpegError`` — never a
    raw Python exception (the reference's whole-API contract: every
    failure is a status code, rocjpeg_api.cpp:168-174);
  - mixed clean+mutated batches exercise per-image error attribution.

Time budget: ROCJPEG_TPU_SOAK_SECS (default 45 s here / CI; a long run
writes its stats to SOAK_OUT, default soak.json, via
``python -m tests.test_soak``).
"""

import json
import os
import sys
import time

import numpy as np
import pytest

from rocjpeg_tpu import api
from rocjpeg_tpu.core import golden
from rocjpeg_tpu.status import RocJpegError
from rocjpeg_tpu.testing import encoder
from rocjpeg_tpu.types import DecodeParams, OutputFormat

CSS = ["444", "440", "422", "420", "411", "400"]
FMTS = [OutputFormat.NATIVE, OutputFormat.RGB, OutputFormat.Y,
        OutputFormat.YUV_PLANAR, OutputFormat.RGB_PLANAR]
# 4:1:1 excluded: decode rejects it with a typed status (reference
# parity — the VA surface-format switch has no 411 case and the samples
# skip it, jpegdecode.cpp:129); that reject path has its own tests.
_SHAPES = [("444", 64, 64), ("440", 80, 68), ("422", 90, 70),
           ("420", 88, 72), ("420", 97, 65), ("420", 96, 64),
           ("400", 73, 81), ("422", 64, 96)]


def _gen_blob(rng):
    """One random-config encoded image + its config tuple."""
    # Shapes come from a fixed matrix (every css, odd and even dims, all
    # >= the 64x64 minimum — reference jpegdecode.cpp:120) so the XLA
    # shape-bucket compiles amortize across the soak and the budget buys
    # decode volume; content, restart structure, tables, and mutations
    # stay fully random per image.
    css, w, h = _SHAPES[int(rng.integers(len(_SHAPES)))]
    ri = int(rng.choice([0, 0, 1, 2, 5]))
    tv = int(rng.integers(0, 2))
    opt = bool(rng.integers(0, 2))
    planes = encoder.random_planes(css, w, h, seed=int(rng.integers(1 << 30)))
    blob = encoder.encode_planes(planes, css, restart_interval=ri,
                                 table_variant=tv, optimize=opt)
    return blob, (css, w, h, ri, tv, opt)


def _mutate(rng, blob):
    # Half clean: all-clean batches (which must decode AND be bit-exact)
    # need several consecutive clean draws to occur.
    kind = 0 if rng.random() < 0.5 else int(rng.integers(1, 4))
    b = bytearray(blob)
    if kind == 0:
        return blob, "clean"
    if kind == 1:
        cut = int(rng.integers(2, len(b)))
        return bytes(b[:cut]), f"trunc@{cut}"
    if kind == 2:
        for _ in range(int(rng.integers(1, 5))):
            i = int(rng.integers(2, len(b)))
            b[i] ^= int(rng.integers(1, 256))
        return bytes(b), "bitflip"
    i = int(rng.integers(2, len(b) - 2))
    b[i:i + 2] = bytes([0xFF, int(rng.choice([0xD0, 0xC2, 0x01, 0xD9]))])
    return bytes(b), "marker"


def _golden_ok(blob, fmt, img):
    ref = golden.decode(blob, fmt)
    for (want, _pitch), got in zip(ref, img.channel):
        if got is None:
            return False
        got = np.asarray(got).reshape(-1)
        want = np.asarray(want).reshape(-1)
        if not np.array_equal(got[:want.size], want):
            return False
    return True


def run_soak(budget_s: float, seed: int = 0, verbose: bool = False):
    rng = np.random.default_rng(seed)
    dec = api.Decoder(device_entropy="auto")
    stats = {"clean": 0, "clean_exact": 0, "mutated": 0,
             "mutated_typed_error": 0, "mutated_decoded": 0,
             "batches": 0, "configs": set()}
    t_end = time.time() + budget_s
    it = 0
    while time.time() < t_end:
        it += 1
        fmt = FMTS[it % len(FMTS)]
        batch, kinds, blobs = [], [], []
        for _ in range(int(rng.integers(2, 6))):
            blob, cfg = _gen_blob(rng)
            stats["configs"].add(cfg[0] + f"_ri{cfg[3]}")
            mut, kind = _mutate(rng, blob)
            blobs.append(mut)
            kinds.append(kind)
        # Parse phase: a typed error here is a valid outcome for mutants.
        streams = []
        for mut, kind in zip(blobs, kinds):
            try:
                streams.append((api.JpegStream(mut), mut, kind))
            except RocJpegError:
                assert kind != "clean"
                stats["mutated"] += 1
                stats["mutated_typed_error"] += 1
            except Exception as e:  # pragma: no cover - the soak's point
                raise AssertionError(
                    f"non-typed parse error for {kind}: {e!r}")
        if not streams:
            continue
        # Batched decode: per-image attribution means one bad image must
        # not take down its batchmates' results.
        try:
            imgs = dec.decode_batched([s for s, _, _ in streams],
                                      DecodeParams(output_format=fmt))
            errs = [None] * len(streams)
        except RocJpegError as e:
            # Whole-batch typed failure: acceptable only if a mutant is
            # present in the batch.
            assert any(k != "clean" for _, _, k in streams), \
                f"clean batch raised: {e}"
            imgs, errs = None, None
        stats["batches"] += 1
        if imgs is None:
            for _, _, kind in streams:
                if kind != "clean":
                    stats["mutated"] += 1
                    stats["mutated_typed_error"] += 1
            continue
        for (stream, mut, kind), img in zip(streams, imgs):
            if kind == "clean":
                stats["clean"] += 1
                assert _golden_ok(mut, fmt, img), \
                    f"clean image not bit-exact (fmt={fmt})"
                stats["clean_exact"] += 1
            else:
                stats["mutated"] += 1
                # A decoded mutant is fine (bit flips in coefficients still
                # parse); what matters is it produced OUTPUT, not a crash.
                stats["mutated_decoded"] += 1
        if verbose and it % 10 == 0:
            print(f"[soak] iter {it}: {stats['clean']} clean / "
                  f"{stats['mutated']} mutated", file=sys.stderr)
    stats["configs"] = sorted(stats["configs"])
    stats["iterations"] = it
    return stats


def test_soak_default_path():
    budget = float(os.environ.get("ROCJPEG_TPU_SOAK_SECS", "45"))
    stats = run_soak(budget, seed=int(os.environ.get("SOAK_SEED", "0")))
    # The sweep must have exercised real volume and every clean image must
    # have come out bit-exact.
    assert stats["clean"] == stats["clean_exact"]
    assert stats["clean"] >= 5
    assert stats["mutated"] >= 5
    assert len(stats["configs"]) >= 4


if __name__ == "__main__":
    budget = float(os.environ.get("ROCJPEG_TPU_SOAK_SECS", "300"))
    stats = run_soak(budget, verbose=True)
    out = {"budget_s": budget, **stats}
    path = os.environ.get("SOAK_OUT", "soak.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
