"""Host-side baseline-DCT Huffman entropy decoder (pure-Python reference).

This stage implements what the reference delegates to the VCN ASIC: it turns
the entropy-coded scan span (``JpegStreamParameters.slice_data_buffer``,
src/rocjpeg_parser.cpp:400-416) into dense per-component coefficient planes.
The restart interval (ParseDRI, parser.cpp:374-390) segments the scan into
independently decodable pieces — DC predictors reset at every RSTn marker —
which is the parallel axis exploited by the multithreaded C++ decoder
(csrc/) and, later, the Pallas on-device entropy kernel.

Output layout: per component, an int16 array of shape
(blocks_h, blocks_w, 64) in *natural* (row-major) coefficient order, padded
to whole MCUs — the exact input the device dequant+IDCT stage consumes.

This Python implementation is the correctness oracle; the C++ extension
(rocjpeg_tpu.runtime.native) is the production host path and must match it
bit-for-bit.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..status import RocJpegError, Status
from .bitstream import JpegStreamParams
from .huffman import CompiledHuffman
from .zigzag import ZIGZAG_ORDER


def split_restart_segments(scan: bytes) -> List[bytes]:
    """Split the entropy-coded span at RSTn markers (0xFFD0..0xFFD7).

    Stuffed 0xFF00 sequences are data, not markers. Returns the list of
    entropy segments with the markers removed; a DRI-less stream yields one
    segment.
    """
    if not scan:
        return [b""]
    b = np.frombuffer(scan, np.uint8)
    is_marker = (b[:-1] == 0xFF) & (b[1:] >= 0xD0) & (b[1:] <= 0xD7)
    starts = np.flatnonzero(is_marker)
    segments = []
    prev = 0
    for s in starts.tolist():
        segments.append(scan[prev:s])
        prev = s + 2
    segments.append(scan[prev:])
    return segments


def unstuff(segment: bytes) -> np.ndarray:
    """Remove byte-stuffing: each 0xFF00 in the entropy stream encodes a
    literal 0xFF data byte (ITU-T T.81 F.1.2.3). Returns uint8 array."""
    b = np.frombuffer(segment, np.uint8)
    if b.size == 0:
        return b
    stuffed = np.flatnonzero((b[:-1] == 0xFF) & (b[1:] == 0x00)) + 1
    if stuffed.size:
        b = np.delete(b, stuffed)
    return b


class BitReader:
    """MSB-first bit reader with O(1) 16-bit peek at any bit offset.

    Precomputes a sliding 32-bit big-endian window per byte so that
    ``peek16`` is one load + shift — the same access pattern the C++ and
    Pallas decoders use.
    """

    __slots__ = ("pos", "nbits", "_w")

    def __init__(self, data: np.ndarray) -> None:
        ext = np.concatenate([data, np.zeros(4, np.uint8)]).astype(np.uint32)
        self._w = ((ext[:-3] << 24) | (ext[1:-2] << 16)
                   | (ext[2:-1] << 8) | ext[3:]).tolist()
        self.pos = 0
        self.nbits = int(data.size) * 8

    def peek16(self) -> int:
        p = self.pos
        return (self._w[p >> 3] >> (16 - (p & 7))) & 0xFFFF

    def get_bits(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (self._w[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1)


def _extend(v: int, s: int) -> int:
    """ITU-T T.81 F.2.2.1 EXTEND: map s-bit magnitude to signed value."""
    if v < (1 << (s - 1)):
        return v - (1 << s) + 1
    return v


def decode_scan(params: JpegStreamParams) -> List[np.ndarray]:
    """Decode the full scan into per-component natural-order coefficient
    planes of shape (blocks_h, blocks_w, 64), int16, MCU-padded."""
    ncomp = len(params.scan_components)
    if ncomp == 0 or not params.components:
        raise RocJpegError(Status.BAD_JPEG, "no scan components")

    # Compile table ids used by the scan.
    tables = {}
    for sc in params.scan_components:
        for tid in (sc.dc_table_selector, sc.ac_table_selector):
            if tid not in tables:
                if tid >= len(params.huffman_tables) or not params.load_huffman_table[tid]:
                    raise RocJpegError(Status.BAD_JPEG, f"huffman table {tid} not loaded")
                tables[tid] = CompiledHuffman(params.huffman_tables[tid])

    outputs = [
        np.zeros(params.component_block_dims(i) + (64,), np.int16)
        for i in range(len(params.components))
    ]

    # Per-component block-write schedule for one MCU (interleaved scan), or
    # the single-block schedule for a one-component scan (T.81 A.2: a scan
    # with one component is non-interleaved; MCU = 1 data unit).
    interleaved = ncomp > 1
    if interleaved:
        mcus_w = params.mcus_per_row
        total_mcus = params.num_mcus
        plan = []  # (comp_idx, vf, hf, v, u, dc_lut_pair, ac_lut_pair)
        for ci, sc in enumerate(params.scan_components):
            fc = params.components[ci]
            t_dc = tables[sc.dc_table_selector]
            t_ac = tables[sc.ac_table_selector]
            for v in range(fc.v_sampling_factor):
                for u in range(fc.h_sampling_factor):
                    plan.append((ci, fc.v_sampling_factor,
                                 fc.h_sampling_factor, v, u, t_dc, t_ac))
    else:
        bh, bw = outputs[0].shape[:2]
        # Non-interleaved plane is tight ceil(W/8) x ceil(H/8); the MCU-padded
        # output array may be larger (sampling>1 grayscale) — write top-left.
        bw = (params.picture_width + 7) // 8
        bh = (params.picture_height + 7) // 8
        mcus_w = bw
        total_mcus = bw * bh
        sc = params.scan_components[0]
        plan = [(0, 1, 1, 0, 0,
                 tables[sc.dc_table_selector], tables[sc.ac_table_selector])]

    segments = split_restart_segments(params.slice_data)
    ri = params.restart_interval
    if ri <= 0:
        ri = total_mcus  # no restarts: one segment covers the scan

    zz = ZIGZAG_ORDER.tolist()
    mcu = 0
    seg_idx = 0

    try:
        mcu = _decode_segments(params, outputs, segments, plan, mcus_w,
                               total_mcus, ri, zz, tables)
    except IndexError:
        # Bit reader ran off the end of a truncated scan.
        raise RocJpegError(Status.BAD_JPEG, "scan data exhausted mid-MCU")
    return outputs


def _decode_segments(params, outputs, segments, plan, mcus_w, total_mcus,
                     ri, zz, tables):
    mcu = 0
    seg_idx = 0
    while mcu < total_mcus:
        if seg_idx >= len(segments):
            raise RocJpegError(Status.BAD_JPEG, "scan data ended before all MCUs")
        reader = BitReader(unstuff(segments[seg_idx]))
        seg_idx += 1
        dc_pred = [0] * len(params.components)
        seg_end = min(mcu + ri, total_mcus)
        peek16 = reader.peek16
        get_bits = reader.get_bits

        for m in range(mcu, seg_end):
            my, mx = divmod(m, mcus_w)
            for ci, vf, hf, v, u, t_dc, t_ac in plan:
                block = [0] * 64
                # --- DC ---
                w = peek16()
                s = t_dc.dc_sym[w]
                length = t_dc.dc_len[w]
                if length == 0:
                    raise RocJpegError(Status.BAD_JPEG, "invalid DC Huffman code")
                reader.pos += int(length)
                s = int(s)
                if s:
                    diff = _extend(get_bits(s), s)
                else:
                    diff = 0
                dc_pred[ci] += diff
                block[0] = dc_pred[ci]
                # --- AC ---
                k = 1
                ac_sym = t_ac.ac_sym
                ac_len = t_ac.ac_len
                while k < 64:
                    w = peek16()
                    rs = int(ac_sym[w])
                    length = int(ac_len[w])
                    if length == 0:
                        raise RocJpegError(Status.BAD_JPEG, "invalid AC Huffman code")
                    reader.pos += length
                    r = rs >> 4
                    size = rs & 15
                    if size == 0:
                        if r != 15:
                            break  # EOB
                        k += 16  # ZRL
                    else:
                        k += r
                        if k > 63:
                            raise RocJpegError(Status.BAD_JPEG, "AC index overflow")
                        block[zz[k]] = _extend(get_bits(size), size)
                        k += 1
                if reader.pos > reader.nbits + 7:
                    raise RocJpegError(Status.BAD_JPEG, "segment bit overrun")
                outputs[ci][my * vf + v, mx * hf + u] = block
        mcu = seg_end
    return mcu
