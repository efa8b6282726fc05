"""Generate docs/formats-and-architectures.md from the capability table in
rocjpeg_tpu/types.py — the analog of the reference's per-architecture
formats table (docs/reference/rocjpeg-formats-and-architectures.rst:20-28),
kept in lockstep with the code by generating instead of hand-writing.

Usage: python tools/gen_formats_doc.py   (rewrites the doc in place)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rocjpeg_tpu import types  # noqa: E402

HEADER = """\
# Supported formats and architectures

<!-- GENERATED by tools/gen_formats_doc.py from rocjpeg_tpu/types.py —
     edit the capability table there, then re-run the generator. -->

## Chroma subsampling x output format

All decode stages are software (XLA/Pallas), so — unlike the reference,
where RGB conversion and ROI decode are MI300-only hardware features
(vaapi_decoder.cpp:296-297) — every supported subsampling decodes to every
output format on every supported device, with ROI fused into the layout
stage.

| Subsampling | NATIVE layout | YUV_PLANAR | Y | RGB | RGB_PLANAR |
|---|---|---|---|---|---|
| 4:4:4 | 3 planes (444P) | yes | yes | yes | yes |
| 4:4:0 | 3 planes, half-height chroma (422V) | yes | yes | yes | yes |
| 4:2:2 | packed YUYV | yes | yes | yes | yes |
| 4:2:0 | Y + interleaved UV (NV12) | yes | yes | yes | yes |
| 4:0:0 | 1 plane (Y800) | yes | yes | yes (Y replicated) | yes |
| 4:1:1 | parsed, rejected at decode (reference parity) | — | — | — | — |

Baseline (sequential DCT, 8-bit) JPEGs only — progressive, lossless,
arithmetic-coded, and 12-bit streams are rejected at parse, and 16-bit
quantization tables at parse (reference parser.cpp:230-233).

## Per-platform decode capabilities

The analog of the reference's VcnJpegSpec table
(src/rocjpeg_vaapi_decoder.cpp:294-305), one row per JAX platform; a
session names its spec after the device's `device_kind`. `decode lanes`
plays the role of `num_jpeg_cores`: the batch-chunk width of one decode
call. The GPU row's value is untuned (not yet measured).

| Platform | Decode lanes | RGB convert | ROI decode | Min | Max |
|---|---|---|---|---|---|
"""

FOOTER = """\

## Restart intervals and virtual restart points

Restart markers (DRI > 0) give the wave kernel its lane parallelism
directly. Streams WITHOUT restart markers (most real-world JPEGs) are
lane-split at *virtual* restart points: a native index pass records the
decode state at symbol-balanced MCU boundaries, and the wave decodes those
segments in parallel (see `ops/device_entropy.pack_virtual_segments`).
Either way the full resolution range above applies.
"""


def main():
    rows = []
    for s in types.SPEC_TABLE.values():
        rows.append(
            f"| {s.name} | {s.num_decode_lanes} | "
            f"{'yes' if s.can_convert_to_rgb else 'no'} | "
            f"{'yes' if s.can_roi_decode else 'no'} | "
            f"{s.min_width}x{s.min_height} | {s.max_width}x{s.max_height} |")
    out = HEADER + "\n".join(rows) + "\n" + FOOTER
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "formats-and-architectures.md")
    with open(path, "w") as f:
        f.write(out)
    print("wrote", path)


if __name__ == "__main__":
    main()
