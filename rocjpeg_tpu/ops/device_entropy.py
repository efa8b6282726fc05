"""On-device baseline Huffman entropy decoder — the "wave".

This is the piece the reference delegates to fixed-function silicon (the VCN
ASIC behind src/rocjpeg_vaapi_decoder.cpp) re-designed for a parallel
machine:

- The *restart interval* (ParseDRI, src/rocjpeg_parser.cpp:374-390) segments
  the scan into independently decodable pieces (DC predictors reset at every
  RSTn marker). Segments become *lanes*: a whole batch's segments decode in
  lockstep, one Huffman symbol per lane per loop step. DRI=0 scans get
  "virtual" restart points from a host index walk
  (:func:`pack_virtual_segments`).
- The host ships the true entropy-coded payload as one dense big-endian
  word stream plus a per-lane word offset (:class:`PackedDense`); decoded
  coefficients never leave the device.
- Two implementations share the packing, the tables and the semantics, and
  the platform picks one (:func:`wave_backend`): on a GPU the Pallas kernel
  in ``kernels/wave_triton.py`` (one lane per thread, coefficients stored
  straight into the output), elsewhere the plain ``jnp`` while loop below
  (:func:`build_wave_decoder`), which is also the reference the kernel's
  tests compare against.

The wave runs exactly once per group (max_steps = a provable hard bound on
symbols per lane), so the decode path performs no host<->device syncs; the
error flags are returned as a device array and checked lazily by the caller.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bitstream import JpegStreamParams
from ..core.zigzag import ZIGZAG_ORDER
from ..status import RocJpegError, Status

# Per-table value capacity: DC tables hold <= 16 symbols, AC <= 162; the
# packed layout allots [0,16,32,194] offsets for (dc0, dc1, ac0, ac1).
_VAL_OFFS = (0, 16, 32, 194)
_VAL_TOTAL = 356
_VAL_WORDS = (_VAL_TOTAL + 3) // 4  # 89

# Inverse zigzag as a static gather: natural position p holds scan index
# INV_ZIGZAG[p] (ZIGZAG_ORDER[s] == p  =>  INV_ZIGZAG[p] == s).
INV_ZIGZAG = np.argsort(np.asarray(ZIGZAG_ORDER)).astype(np.int32)


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------

def build_canonical_tables(bits: np.ndarray, values: np.ndarray):
    """Canonical Huffman decode tables (T.81 Annex F.2.2.3):
    per code length 1..16, maxcode+1 (0 when the length has no codes; needs
    17 bits since a full 16-bit code space gives 2^16) and
    base15 = (valptr - mincode) mod 2^15 so that
    value_index = (code + base15) mod 2^15 (valid because value indices are
    < 2^15)."""
    maxc1 = np.zeros(16, np.uint32)
    base15 = np.zeros(16, np.uint32)
    code = 0
    k = 0
    for length in range(1, 17):
        n = int(bits[length - 1])
        if n:
            base15[length - 1] = (k - code) & 0x7FFF
            maxc1[length - 1] = code + n  # maxcode+1
            code += n
            k += n
        code <<= 1
    return maxc1, base15


@dataclasses.dataclass
class DeviceScanTables:
    """Packed decode tables for the 4 (dc0, dc1, ac0, ac1) table slots, for
    ``n_banks`` table BANKS (bank b = one image's table set; lanes carry a
    bank index, so a group needs only shape uniformity, not shared tables —
    the analog of the reference forwarding per-image DHTs to hardware,
    vaapi_decoder.cpp:694-834).

    lentab: (4 * n_banks, 16) uint32, (maxcode+1) << 15 | base15 per length.
    values: (n_banks * _VAL_WORDS,) uint32, 4 symbol bytes per word, tables
            at _VAL_OFFS byte offsets within each bank.
    """
    lentab: np.ndarray
    values: np.ndarray
    digest: bytes
    n_banks: int = 1

    @classmethod
    def from_params(cls, p: JpegStreamParams) -> "DeviceScanTables":
        lentab = np.zeros((4, 16), np.uint32)
        vals = np.zeros(_VAL_TOTAL, np.uint8)
        for slot in range(4):
            which, tid = ("dc", slot) if slot < 2 else ("ac", slot - 2)
            t = p.huffman_tables[tid] if tid < len(p.huffman_tables) else None
            if t is None or not p.load_huffman_table[tid]:
                continue
            if which == "dc":
                bits, values = t.num_dc_codes, t.dc_values
            else:
                bits, values = t.num_ac_codes, t.ac_values
            maxc1, base15 = build_canonical_tables(bits, values)
            lentab[slot] = (maxc1 << 15) | base15
            off = _VAL_OFFS[slot]
            cap = (_VAL_OFFS[slot + 1] if slot < 3 else _VAL_TOTAL) - off
            n = min(len(values), cap)
            vals[off:off + n] = values[:n]
        packed = (vals[0::4].astype(np.uint32)
                  | (vals[1::4].astype(np.uint32) << 8)
                  | (vals[2::4].astype(np.uint32) << 16)
                  | (vals[3::4].astype(np.uint32) << 24))
        digest = lentab.tobytes() + packed.tobytes()
        return cls(lentab, packed, digest, 1)

    @classmethod
    def from_params_banked(cls, params_list, max_banks: int = 4):
        """Dedup the group's table sets into banks. Returns
        (tables, bank_of_image int32 (B,)); raises
        RocJpegError(JPEG_NOT_SUPPORTED) past ``max_banks`` distinct sets
        (callers fall back to the host path). Bank count is a jit key —
        uniform groups (1 bank) compile the exact single-table program."""
        banks = []
        digests = {}
        bank_of = np.zeros(len(params_list), np.int32)
        for i, p in enumerate(params_list):
            t = cls.from_params(p)
            b = digests.get(t.digest)
            if b is None:
                b = len(banks)
                if b >= max_banks:
                    raise RocJpegError(
                        Status.JPEG_NOT_SUPPORTED,
                        f"more than {max_banks} Huffman table sets in group")
                digests[t.digest] = b
                banks.append(t)
            bank_of[i] = b
        lentab = np.concatenate([t.lentab for t in banks])
        values = np.concatenate([t.values for t in banks])
        return cls(lentab, values, b"|".join(t.digest for t in banks),
                   len(banks)), bank_of


@dataclasses.dataclass
class PackedDense:
    """Device-ready segment wave for one decode group: the segments as one
    word-aligned big-endian stream (the true entropy-coded payload) plus a
    per-lane starting word offset. Lane l's j-th word is
    ``dense[word_off[l] + j]`` for j < n_words; the stream carries a zero
    tail of n_words words so every lane's window is in range.

    Lane count and word count are bucketed so jit programs are reused
    across batches; padding lanes have mcu_count == 0 and deactivate on
    step one."""
    dense: np.ndarray      # (W,) uint32, big-endian packed bytes
    word_off: np.ndarray   # (n_lanes,) int32 — lane's first word in dense
    img_base: np.ndarray   # (n_lanes,) int32 — img_idx * total_blocks
    mcu_start: np.ndarray  # (n_lanes,) int32
    mcu_count: np.ndarray  # (n_lanes,) int32
    n_lanes: int
    n_words: int
    total_bytes: int
    max_seg_bits: int
    max_lane_syms: int = 0  # EXACT max symbols in any lane (0 = unknown)
    lane_bank: np.ndarray = None  # (n_lanes,) int32 table-bank per lane


def _segment_image(scan: bytes):
    """One vectorized pass over a scan: remove byte stuffing (0xFF00 -> 0xFF)
    and RSTn markers, returning (clean bytes, segment start offsets within
    clean)."""
    b = np.frombuffer(scan, np.uint8)
    if b.size < 2:
        return b.copy(), np.zeros(0, np.int64)
    ff = np.flatnonzero(b[:-1] == 0xFF)
    nxt = b[ff + 1]
    stuffed = ff[nxt == 0x00] + 1               # drop the stuffed 0x00
    markers = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]  # drop both marker bytes
    del_pos = np.concatenate([stuffed, markers, markers + 1])
    del_pos.sort(kind="stable")
    clean = np.delete(b, del_pos) if del_pos.size else b.copy()
    bounds = markers - np.searchsorted(del_pos, markers)
    return clean, bounds


_PACK_POOL = None


def _pack_pool():
    """Shared thread pool for the native packer (the C side releases the
    GIL). Mirrors the reference's sample-level ThreadPool
    (samples/rocjpeg_samples_utils.h:671-729) at the library layer."""
    global _PACK_POOL
    if _PACK_POOL is None:
        import concurrent.futures
        import os
        _PACK_POOL = concurrent.futures.ThreadPoolExecutor(
            max(1, os.cpu_count() or 1))
    return _PACK_POOL


class _IdxBufPool:
    """Free-list of index-job buffer sets, so the per-decode virtual-restart
    pass reuses its 2+ MiB clean buffers instead of mmap/fault-ing fresh
    pages every call (~1 ms/image on a 4K DRI=0 scan — the reference's
    analog is the VA surface pool, vaapi_decoder.cpp:34-281).

    Buffer sets are keyed by bucketed (clean_bytes, n_records) capacity.
    acquire() returns (token, bufs_list); release(token) returns the set to
    the pool. Results sliced from pooled buffers must not outlive the
    release — pack_virtual_segments copies everything it returns."""

    def __init__(self, max_sets: int = 8):
        import threading
        self._lock = threading.Lock()
        self._free = {}  # key -> list of buffer-set lists
        self._max_sets = max_sets

    def acquire(self, n_jobs, clean_bytes, n_rec):
        key = (_bucket(max(clean_bytes, 1), 1 << 16),
               _bucket(max(n_rec, 1), 256))
        with self._lock:
            sets = self._free.get(key)
            if sets:
                got = sets.pop()
                if len(got) >= n_jobs:
                    return (key, got), got[:n_jobs]
                # Too small a set (larger batch than before): grow it.
                got.extend(self._alloc(key) for _ in range(n_jobs - len(got)))
                return (key, got), got[:n_jobs]
        got = [self._alloc(key) for _ in range(n_jobs)]
        return (key, got), got

    def _alloc(self, key):
        cb, nr = key
        return (np.empty(cb, np.uint8), np.empty(nr, np.int64),
                np.empty((nr, 3), np.int32), np.empty(nr, np.int32),
                np.empty(nr, np.int32))

    def release(self, token):
        key, got = token
        with self._lock:
            sets = self._free.setdefault(key, [])
            if len(sets) < self._max_sets:
                sets.append(got)


_IDX_BUF_POOL = _IdxBufPool()


class _RingPool:
    """Round-robin rings of the LARGE per-batch output buffers (the dense
    word stream and lane_of_mcu), keyed by exact (shape, dtype).

    Why: these escape pack_virtual_segments into device_put/jit, so the
    free-list pattern (_IdxBufPool) can't know when to release them.
    Allocating them fresh per call was measured to SERIALIZE concurrent
    submit threads: an 84 MB np.zeros + fault-on-write + munmap cycle per
    batch means cross-core TLB shootdowns and mmap_sem contention in the
    shared address space — 2-thread scaling of the host pack path was
    0.75-1.08x with fresh buffers vs ~1.9x without the big writes (two
    PROCESSES, separate address spaces, always scaled cleanly).

    A ring hands the same buffer out again only after ``depth`` further
    acquisitions of its key. depth=8 covers the deepest in-flight window
    (2 submit threads x depth-2 pipeline x <= 2 throttled device programs
    -> <= 4 batches whose H2D may still be streaming) with 2x margin.
    Buffers are DIRTY on acquire; callers must overwrite every byte they
    let the device read, or zero explicitly (the ROI path does)."""

    def __init__(self, depth: int = 8, max_keys: int = 32):
        import threading
        self._lock = threading.Lock()
        self._depth = depth
        self._max_keys = max_keys
        self._rings = {}  # key -> [buffers]
        self._next = {}   # key -> next slot
        self._order = []  # LRU key order

    def acquire(self, shape, dtype) -> np.ndarray:
        key = (tuple(np.atleast_1d(shape).tolist())
               if not np.isscalar(shape) else (int(shape),),
               np.dtype(dtype).str)
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                if len(self._rings) >= self._max_keys and self._order:
                    old = self._order.pop(0)
                    self._rings.pop(old, None)
                    self._next.pop(old, None)
                # Allocate the WHOLE ring up front and pre-fault every
                # page (fill(0)), so first-touch page faults land on the
                # first (warmup) acquire of a key, never inside a timed
                # decode call.
                ring = self._rings[key] = [np.empty(shape, dtype)
                                           for _ in range(self._depth)]
                for b in ring:
                    b.fill(0)
                self._next[key] = 0
            if key in self._order:
                self._order.remove(key)
            self._order.append(key)
            i = self._next[key]
            self._next[key] = (i + 1) % self._depth
            return ring[i]


_BATCH_BUF_POOL = _RingPool()


def _bucket(n: int, quantum: int) -> int:
    """Round n up to a power-of-two-ish bucket (1-2-4-... times quantum)."""
    b = quantum
    while b < n:
        b <<= 1
    return b


def lane_quantum() -> int:
    """Lane-count quantum of a packed group: the GPU kernel's lane block,
    and the (R, 128) lane tiles of the ``jnp`` wave."""
    from ..kernels.wave_triton import LANE_BLOCK
    return max(128, LANE_BLOCK)


def _bucket_fine(n: int, quantum: int) -> int:
    """Round n up to a 1/8-geometric bucket (pow2 times 8/9/10.../15 of a
    quantum; a multiple of the quantum). Max waste 12.5%, where a pow2
    bucket can double host->device bytes or lanes; the cost is a few more
    compiled shapes."""
    b = quantum
    while b * 2 < n:
        b <<= 1
    if n <= b:
        return b
    step = max(b // 8, quantum)
    return b + -(-(n - b) // step) * step


def _geometry_rows(params_list, total_blocks):
    """Per-image segment geometry: (needed segment count, restart interval,
    total MCUs) without touching the scan bytes."""
    rows = []
    for p in params_list:
        interleaved = len(p.scan_components) > 1
        if interleaved:
            total = p.num_mcus
        else:
            total = ((p.picture_width + 7) // 8) * ((p.picture_height + 7) // 8)
        ri = p.restart_interval if p.restart_interval > 0 else total
        needed = (total + ri - 1) // ri
        rows.append((needed, ri, total))
    return rows


def pack_segments(params_list: Sequence[JpegStreamParams],
                  total_blocks: int,
                  lanes_per_image: int = 0,
                  mcu_range=None,
                  bank_of=None) -> PackedDense:
    """Split each image's scan at RSTn markers, unstuff, and pack all
    segments of the group into one dense word stream (bits MSB-first within
    each big-endian word) with per-lane word offsets. Uses the native C
    packer (csrc/rocjpeg_entropy.cpp rjt_seg_lens/rjt_pack_dense) when
    available, with a vectorized numpy fallback.

    lanes_per_image > 0 switches to the mesh layout: every image occupies
    exactly ``lanes_per_image`` lanes (padding lanes interleaved per image,
    image i starting at lane i*lanes_per_image) so the lane axis shards
    evenly over a batch-sharded mesh.

    mcu_range=(lo, hi) packs ONLY the restart segments
    intersecting that MCU index range — the ROI fast path (the reference
    decodes only the crop in hardware on MI300, vaapi_decoder.cpp:640-658):
    byte stuffing is context-free and DC predictors reset at every RSTn, so
    a crop's segments decode without touching the rest of the scan. Blocks
    outside the packed lanes stay zero in the coefficient tensor and are
    sliced away by the ROI layout stage."""
    from ..runtime import host_decode
    native = host_decode.native_pack_module()

    geo = _geometry_rows(params_list, total_blocks)
    sel = None
    if mcu_range is not None:
        lo, hi = mcu_range
        sel = []
        for needed, ri, total in geo:
            s0 = max(0, min(lo // ri, needed))
            s1 = max(s0, min(needed, -(-hi // ri)))
            sel.append((s0, s1))
        geo_sel = [(s1 - s0, ri, total)
                   for (s0, s1), (_n, ri, total) in zip(sel, geo)]
    else:
        geo_sel = geo
    if lanes_per_image:
        if any(g[0] > lanes_per_image for g in geo):
            raise RocJpegError(Status.INVALID_PARAMETER,
                               "lanes_per_image below a segment count")
        lane_starts = [i * lanes_per_image for i in range(len(geo))]
        n_pad = lanes_per_image * len(geo)
        if n_pad % lane_quantum():
            raise RocJpegError(
                Status.INVALID_PARAMETER,
                f"lanes_per_image * batch must be a multiple of "
                f"{lane_quantum()}")
    else:
        starts = []
        acc = 0
        for g in geo_sel:
            starts.append(acc)
            acc += g[0]
        lane_starts = starts
        n_pad = _bucket(max(acc, 1), max(256, lane_quantum()))

    # ---- phase 1: clean segment lengths (native or numpy) ----
    seg_len_rows = []
    raw_starts = None
    cleans = None
    use_offsets = sel is not None and getattr(native, "SEG_OFFSETS_AVAILABLE",
                                              False)
    if native is not None and use_offsets:
        raw_starts = [0] * len(params_list)

        def _lens_sel(arg):
            i, (p, (needed, ri, total)) = arg
            lens, raw, found = native.seg_offsets(p.slice_data, needed)
            if found < needed:
                raise RocJpegError(Status.BAD_JPEG, "missing restart segments")
            s0, s1 = sel[i]
            raw_starts[i] = int(raw[s0]) if s0 < needed else len(p.slice_data)
            return lens[s0:s1]

        jobs = list(enumerate(zip(params_list, geo)))
        if len(jobs) > 1:
            seg_len_rows = list(_pack_pool().map(_lens_sel, jobs))
        else:
            seg_len_rows = [_lens_sel(j) for j in jobs]
    elif native is not None and sel is None:
        def _lens(arg):
            p, (needed, ri, total) = arg
            lens, found = native.seg_lens(p.slice_data, needed)
            if found < needed:
                raise RocJpegError(Status.BAD_JPEG, "missing restart segments")
            return lens[:needed]

        jobs = list(zip(params_list, geo))
        if len(jobs) > 1:
            seg_len_rows = list(_pack_pool().map(_lens, jobs))
        else:
            seg_len_rows = [_lens(j) for j in jobs]
    else:
        native = None  # numpy fallback packs from `cleans` below
        cleans = []
        for i, (p, (needed, ri, total)) in enumerate(zip(params_list, geo)):
            clean, bounds = _segment_image(p.slice_data)
            if bounds.size + 1 < needed:
                raise RocJpegError(Status.BAD_JPEG, "missing restart segments")
            seg_starts = np.concatenate([[0], bounds])[:needed]
            seg_ends = np.concatenate([bounds, [clean.size]])[:needed]
            s0, s1 = sel[i] if sel is not None else (0, needed)
            cleans.append((clean, seg_starts[s0:s1]))
            seg_len_rows.append((seg_ends - seg_starts)[s0:s1]
                                .astype(np.int32))

    all_len = np.concatenate(seg_len_rows) if seg_len_rows else np.zeros(0, np.int64)
    max_len = int(all_len.max()) if all_len.size else 0
    n_words = (max_len + 3) // 4 + 2  # +2 pad words so window fetch is safe
    n_words = _bucket(-(-n_words // 8) * 8, 8)  # whole 8-word slabs, pow2ish
    seg0 = [s[0] for s in sel] if sel is not None else None
    return _pack_dense_phase2(params_list, geo_sel, lane_starts, n_pad,
                              n_words, seg_len_rows, cleans, native,
                              total_blocks, all_len, max_len,
                              seg0=seg0, raw_starts=raw_starts,
                              bank_of=bank_of)


def _lane_geometry(geo, lane_starts, n_pad, total_blocks, seg0=None):
    img_base = np.zeros(n_pad, np.int32)
    mcu_start = np.zeros(n_pad, np.int32)
    mcu_count = np.zeros(n_pad, np.int32)
    for i, ((needed, ri, total), l0) in enumerate(zip(geo, lane_starts)):
        sl = slice(l0, l0 + needed)
        img_base[sl] = i * total_blocks
        s0 = seg0[i] if seg0 is not None else 0
        ms = (s0 + np.arange(needed, dtype=np.int32)) * ri
        mcu_start[sl] = ms
        mcu_count[sl] = np.minimum(ri, total - ms)
    return img_base, mcu_start, mcu_count


def _pack_dense_phase2(params_list, geo, lane_starts, n_pad, n_words,
                       seg_len_rows, cleans, native,
                       total_blocks, all_len, max_len, seg0=None,
                       raw_starts=None, bank_of=None) -> PackedDense:
    """Phase 2 of the dense-H2D pack: per-lane word offsets (exclusive
    prefix sum of ceil(len/4)) + one dense word stream, written by the
    native packer (rjt_pack_dense) or the numpy fallback.

    seg0/raw_starts: ROI-selective packing — per image, the first packed
    segment's index and its raw byte offset within the stuffed scan (byte
    stuffing is context-free, so the native packer starts mid-scan)."""
    # Per-lane word counts in GROUP lane order; padding lanes occupy zero
    # words and point at the zeroed tail of the stream.
    lane_words = np.zeros(n_pad, np.int64)
    for lens, l0 in zip(seg_len_rows, lane_starts):
        lane_words[l0:l0 + lens.size] = (lens.astype(np.int64) + 3) // 4
    word_off = np.zeros(n_pad + 1, np.int64)
    np.cumsum(lane_words, out=word_off[1:])
    used_words = int(word_off[-1])
    # Pad lanes (lane_words == 0) read from [their offset, +n_words); the
    # +n_words zero tail keeps every lane's full window in range, and the
    # total is bucketed so jit programs are reused across batches.
    w_pad = _bucket_fine(used_words + n_words, 1 << 16)
    dense = np.zeros(w_pad, np.uint32)
    word_off32 = word_off[:n_pad].astype(np.int32)

    if native is not None and getattr(native, "DENSE_PACK_AVAILABLE", False):
        jobs = []
        for i, (p, (needed, ri, total), l0) in enumerate(
                zip(params_list, geo, lane_starts)):
            data = p.slice_data
            if raw_starts is not None and raw_starts[i]:
                data = data[raw_starts[i]:]
            jobs.append((data, word_off32[l0:l0 + needed], needed))
        if len(jobs) > 1:
            list(_pack_pool().map(
                lambda j: native.pack_dense(j[0], dense, j[1], j[2]), jobs))
        else:
            for data, offs, needed in jobs:
                native.pack_dense(data, dense, offs, needed)
    else:
        u8 = dense.view(np.uint8)
        if cleans is None:  # native seg_lens ran but dense packer missing
            cleans = []
            for p in params_list:
                clean, bounds = _segment_image(p.slice_data)
                seg_starts = np.concatenate([[0], bounds])
                cleans.append((clean, seg_starts))
        for (clean, seg_starts), lens, l0 in zip(cleans, seg_len_rows,
                                                 lane_starts):
            nseg = lens.size
            if not nseg:
                continue
            # Selected segments are contiguous in `clean`; index relative
            # to the first packed segment so ROI slices pack correctly.
            start0 = int(seg_starts[0])
            used = int(seg_starts[nseg - 1] + lens[-1]) - start0
            lens64 = lens.astype(np.int64)
            base = np.repeat(word_off[l0:l0 + nseg] * 4, lens64)
            within = np.arange(used, dtype=np.int64) - np.repeat(
                seg_starts[:nseg].astype(np.int64) - start0, lens64)
            u8[base + (within & ~np.int64(3)) + (3 - (within & 3))] = \
                clean[start0:start0 + used]

    img_base, mcu_start, mcu_count = _lane_geometry(
        geo, lane_starts, n_pad, total_blocks, seg0=seg0)
    lane_bank = np.zeros(n_pad, np.int32)
    if bank_of is not None:
        for i, ((needed, ri, total), l0) in enumerate(zip(geo, lane_starts)):
            lane_bank[l0:l0 + needed] = bank_of[i]
    return PackedDense(
        dense=dense,
        word_off=word_off32,
        img_base=img_base,
        mcu_start=mcu_start,
        mcu_count=mcu_count,
        n_lanes=n_pad,
        n_words=n_words,
        total_bytes=int(all_len.sum()),
        max_seg_bits=max_len * 8,
        lane_bank=lane_bank,
    )


def _lane_geometry_py(scans, lane_starts, total_blocks, bank_of,
                      lane_words, bit_starts, bit_ends, img_base,
                      mcu_start, mcu_count, lane_bank, dc_flat,
                      lane_of_mcu):
    """Pure-Python lane bookkeeping — the fallback when the loaded native
    library predates rjt_lane_geometry, and the oracle the native pass is
    tested against (tests/test_device_entropy.py)."""
    for i, (clean, bo, dc, mi, sc, end_bit, end_mcu) in enumerate(scans):
        l0 = lane_starts[i]
        n_rec = len(bo)
        ends = np.append(bo[1:], end_bit)
        lens = ends - bo
        sl = slice(l0, l0 + n_rec)
        bit_starts[sl] = bo
        bit_ends[sl] = ends
        lane_words[sl] = (lens + 31) // 32
        # The last kept lane extends to the next (possibly dropped) record
        # or the image end — both its bit span and MCU count honor that.
        nxt = np.append(mi[1:], end_mcu) if n_rec else mi
        counts = (nxt - mi).astype(np.int32)
        img_base[sl] = i * total_blocks
        mcu_start[sl] = mi
        mcu_count[sl] = counts
        if bank_of is not None:
            lane_bank[sl] = bank_of[i]
        dc_flat[sl] = dc
        if n_rec:
            span0 = int(mi[0])
            lane_of_mcu[i, span0:span0 + int(counts.sum())] = np.repeat(
                np.arange(l0, l0 + n_rec, dtype=np.int32), counts)


def pack_virtual_segments(params_list: Sequence[JpegStreamParams],
                          total_blocks: int,
                          min_symbols: int,
                          mcu_range=None,
                          bank_of=None):
    """Pack DRI=0 scans for the wave by manufacturing restart points: the
    native index pass (csrc rjt_index_scan) walks each image's Huffman
    stream once on the host, recording (bit offset, MCU index, DC
    predictors) at the first MCU boundary after every >= ``min_symbols``
    symbols; each such "virtual segment" becomes a wave lane, bit-aligned
    during the pack (rjt_pack_bits) so the kernel needs no skip-bits
    support. Symbol-balanced lanes bound the wave's loop trip count by the
    record interval (a fixed-MCU split lets one dense region blow it up
    ~16x) and equalize per-lane work.

    Returns (PackedDense, dc_flat int32 (n_lanes, 3),
    lane_of_mcu int32 (B, total_mcus)): dc_flat[l, c] is component c's DC
    predictor entering lane l (added to every DC coefficient the lane
    emits — a lane decoded from predictor 0 is off by exactly its entry
    predictor, since DC is cumulative); lane_of_mcu[b, m] is the global
    lane that decodes MCU m of image b (the DC-fixup gather key).

    mcu_range=(lo, hi): pack only the lanes intersecting that MCU index
    range (ROI fast path). The index walk still covers the whole stream —
    bit offsets require it — but the wave decodes, and the link carries,
    only the crop's lanes.

    Raises RocJpegError(BAD_JPEG) if any index walk hits an invalid code;
    callers fall back to the host path, which reports precisely.
    """
    from ..runtime import host_decode
    native = host_decode.native_index_module()
    if native is None:
        raise RocJpegError(Status.NOT_IMPLEMENTED, "native index pass absent")

    p0 = params_list[0]
    interleaved = len(p0.scan_components) > 1
    if interleaved:
        total = p0.num_mcus
    else:
        total = (((p0.picture_width + 7) // 8)
                 * ((p0.picture_height + 7) // 8))
    S = max(1, min_symbols)
    B = len(params_list)

    # ---- phase 1: index scans (native releases the GIL; pool across
    # images like the restart packer). Groups of SIXTEEN walk in AVX-512
    # lockstep (rjt_index_scan16) when the host has it, groups of EIGHT
    # in AVX2 (rjt_index_scan8, ~2.3x two interleaved scalar walks);
    # remainders and non-SIMD hosts fall back to the dual-stream scalar
    # walker, which overlaps two streams' dependency chains on one core. ----
    import threading

    from ..runtime import native as nat

    buf_tokens = []
    buf_lock = threading.Lock()

    def _chunk_bufs(chunk):
        """Pooled per-job buffers for one chunk (released at function end;
        nothing sliced from them escapes — the bookkeeping below copies)."""
        caps = [nat.index_job_capacities(p, S) for p in chunk]
        token, bufs = _IDX_BUF_POOL.acquire(
            len(chunk), max(c[0] for c in caps), max(c[1] for c in caps))
        with buf_lock:
            buf_tokens.append(token)
        return bufs

    def _scan_chunk(chunk):
        if len(chunk) == 32:
            out = getattr(native, "index_scan32", lambda *a, **k: None)(
                chunk, S, _chunk_bufs(chunk))
            if out is not None:
                return out
            # Fallback (non-uniform jobs): two 16-lane walks.
            a = _scan_chunk(chunk[:16])
            return a + _scan_chunk(chunk[16:])
        if len(chunk) == 16:
            out = getattr(native, "index_scan16", lambda *a, **k: None)(
                chunk, S, _chunk_bufs(chunk))
            if out is not None:
                return out
            # AVX-512 unavailable: split into two 8-lane walks.
            a = _scan_chunk(chunk[:8])
            return a + _scan_chunk(chunk[8:])
        if len(chunk) == 8:
            out = native.index_scan8(chunk, S, _chunk_bufs(chunk))
            if out is not None:
                return out
        out = []
        for i in range(0, len(chunk), 2):
            pair = chunk[i:i + 2]
            if len(pair) == 2:
                out.extend(native.index_scan2(pair[0], pair[1], S))
            else:
                out.append(native.index_scan(pair[0], S))
        return out

    # Chunk width: prefer 16-lane AVX-512 walks (measured ~1.8x one core's
    # 8-lane throughput, i.e. one scan16 ~= two parallel scan8 cores while
    # freeing the second core for other callers' chunks). The capability is
    # a static CPU probe — never build 16 jobs just to be told no.
    avx512 = getattr(native, "index_scan16_available", lambda: False)()
    if avx512 and B >= 32 and hasattr(native, "index_scan32"):
        # Two interleaved 16-lane groups per call: ~1.5x one core's 16-lane
        # aggregate (gather-chain overlap). Only when the batch fills whole
        # 32-wide chunks per pool worker; smaller batches stay at 16 so the
        # two cores split the work instead of one core walking everything.
        cw = 32
    elif avx512 and B >= 16:
        cw = 16
    else:
        cw = 8
    chunks = [params_list[i:i + cw] for i in range(0, B, cw)]
    if len(chunks) > 1:
        scans = [r for rs in _pack_pool().map(_scan_chunk, chunks)
                 for r in rs]
    else:
        scans = [r for c in chunks for r in _scan_chunk(c)]

    # Normalize each scan to (clean, bo, dc, mi, sc, end_bit, end_mcu):
    # the end markers bound the LAST lane (next record's position, or the
    # stream/image end), which matters when an MCU range drops the tail.
    norm = []
    for clean, bo, dc, mi, sc in scans:
        norm.append((clean, bo, dc, mi, sc, len(clean) * 8, total))
    scans = norm
    if mcu_range is not None:
        # Keep only lanes intersecting [lo, hi): records are sorted by MCU,
        # so the selection is one contiguous slice per image.
        lo, hi = mcu_range
        filtered = []
        for clean, bo, dc, mi, sc, eb, em in scans:
            i0 = max(0, int(np.searchsorted(mi, lo, side="right")) - 1)
            i1 = int(np.searchsorted(mi, hi, side="left"))
            i1 = max(i1, i0)
            if i1 < len(bo):
                eb, em = int(bo[i1]), int(mi[i1])
            filtered.append((clean, bo[i0:i1], dc[i0:i1], mi[i0:i1],
                             sc[i0:i1], eb, em))
        scans = filtered

    lane_starts = []
    acc = 0
    total_bytes = 0
    meta = []
    for i, (clean, bo, dc, mi, sc, eb, em) in enumerate(scans):
        lane_starts.append(acc)
        meta.append((bo, dc, mi, sc, eb, em, acc, i * total_blocks,
                     int(bank_of[i]) if bank_of is not None else 0, i))
        acc += len(bo)
        total_bytes += len(clean)

    use_native_geom = getattr(native, "geometry_available", lambda: False)()
    if use_native_geom:
        # Native bookkeeping (rjt_record_maxes / rjt_lane_geometry): the
        # per-batch record aggregation releases the GIL, so concurrent
        # submit threads' packs overlap instead of serializing here
        # (measured: the Python loop alone capped 2-thread host scaling
        # at 1.34x on the mug leg).
        geom_jobs = native.build_geom_jobs(meta)
        max_bits, max_syms = native.record_maxes(geom_jobs, len(meta))
    else:
        geom_jobs = None
        max_syms = 0
        max_bits = 0
        for clean, bo, dc, mi, sc, eb, em in scans:
            if sc.size:
                max_syms = max(max_syms, int(sc.max()))
            if len(bo):
                max_bits = max(max_bits,
                               int((np.append(bo[1:], eb) - bo).max()))

    # Word budget per lane: multiple of 8 (the wave's word-slab width),
    # 1/8-geometric — the pow2 bucket inflated a 160-word budget to 256
    # (1.6x wave work) on the 4K DRI=0 corpus.
    n_words = (max_bits + 31) // 32 + 2
    n_words = (_bucket_fine(n_words, 64) if n_words > 8
               else _bucket(-(-n_words // 8) * 8, 8))
    # Lane padding: a 1/8-geometric bucket of the wave's lane quantum, so
    # the kernel's grid divides exactly, padding stays <= 12.5% (a pow2
    # bucket can double the lane grid) and lane counts reuse programs.
    n_pad = _bucket_fine(max(acc, 1), lane_quantum())

    # ---- per-lane geometry + dense word offsets ----
    lane_words = np.zeros(n_pad, np.int64)
    bit_starts = np.zeros(n_pad, np.int64)
    bit_ends = np.zeros(n_pad, np.int64)
    img_base = np.zeros(n_pad, np.int32)
    mcu_start = np.zeros(n_pad, np.int32)
    mcu_count = np.zeros(n_pad, np.int32)
    lane_bank = np.zeros(n_pad, np.int32)
    dc_flat = np.zeros((n_pad, 3), np.int32)
    # Ring-pooled (dirty) large buffer: every row is fully overwritten on
    # the full-image path (record 0 is always MCU 0 and the last lane
    # extends to total), so only the ROI path needs an explicit zero.
    lane_of_mcu = _BATCH_BUF_POOL.acquire((B, total), np.int32)
    if mcu_range is not None:
        lane_of_mcu[:] = 0
    if use_native_geom:
        native.lane_geometry(geom_jobs, len(meta), lane_words, bit_starts,
                             bit_ends, img_base, mcu_start, mcu_count,
                             lane_bank, dc_flat, lane_of_mcu, total)
    else:
        _lane_geometry_py(scans, lane_starts, total_blocks, bank_of,
                          lane_words, bit_starts, bit_ends,
                          img_base, mcu_start, mcu_count, lane_bank,
                          dc_flat, lane_of_mcu)

    word_off = np.zeros(n_pad + 1, np.int64)
    np.cumsum(lane_words, out=word_off[1:])
    used_words = int(word_off[-1])
    w_pad = _bucket_fine(used_words + n_words, 1 << 16)
    # Ring-pooled (dirty): pack_bits overwrites every word in
    # [0, used_words); the slack tail is only ever gathered by zero-length
    # padding lanes (mcu_count 0), which emit nothing — exactly as true
    # for the zero-filled slack before pooling.
    dense = _BATCH_BUF_POOL.acquire(w_pad, np.uint32)
    word_off32 = word_off[:n_pad].astype(np.int32)

    # ---- phase 2: bit-aligned lane copies into the dense stream ----
    # Inline, not pooled: the AVX-512 pack is ~0.5 ms/image, below the
    # pool's per-job dispatch cost (32 futures measured ~1 ms each of
    # wall under GIL contention); concurrent submit threads each pack
    # their own batch on their own core instead.
    dense_u8 = dense.view(np.uint8)
    for i, (clean, bo, dc, mi, sc, eb, em) in enumerate(scans):
        sl = slice(lane_starts[i], lane_starts[i] + len(bo))
        native.pack_bits(clean, dense_u8, word_off32[sl],
                         bit_starts[sl], bit_ends[sl])

    packed = PackedDense(
        dense=dense,
        word_off=word_off32,
        img_base=img_base,
        mcu_start=mcu_start,
        mcu_count=mcu_count,
        n_lanes=n_pad,
        n_words=n_words,
        total_bytes=total_bytes,
        max_seg_bits=max_bits,
        max_lane_syms=max_syms,
        lane_bank=lane_bank,
    )
    # Everything sliced from pooled walk buffers has been copied; return
    # the sets for the next call (on an exception above they are simply
    # GC'd — the pool hands out fresh ones).
    for token in buf_tokens:
        _IDX_BUF_POOL.release(token)
    return packed, dc_flat, lane_of_mcu


@functools.lru_cache(maxsize=64)
def _unbundle_fn(layout):
    """Jitted splitter for stage_small_args: one flat int32 device array ->
    the original (shape, dtype) tuple of arrays, all on device. ``layout``
    is a tuple of (n_elems, shape, dtype_str); offsets are static, so this
    compiles once per layout (shapes are bucketed upstream)."""

    @jax.jit
    def f(flat):
        outs = []
        off = 0
        for n, shape, dt in layout:
            seg = flat[off:off + n].reshape(shape)
            if dt == "uint32":
                seg = jax.lax.bitcast_convert_type(seg, jnp.uint32)
            outs.append(seg)
            off += n
        return tuple(outs)

    return f


def stage_small_args(arrays):
    """ONE host->device transfer for many small arrays.

    ``arrays``: list of (name, np.ndarray) with int32/uint32 dtype. Returns
    {name: device array} with original shapes/dtypes.

    Why: a decode call ships ~12 arrays (lane geometry, Huffman table
    banks, quant tables, DC predictors, the word stream), and every
    transfer carries a fixed latency; concatenating them host-side and
    slicing on device pays it once. Whether this still beats direct
    transfers over a local PCIe link is an open measurement (ROADMAP A5)."""
    metas = []
    parts = []
    total = 0
    for name, a in arrays:
        dt = str(a.dtype)
        assert dt in ("int32", "uint32"), (name, dt)
        a32 = a.view(np.int32) if a.dtype == np.uint32 else a
        parts.append(np.ascontiguousarray(a32).ravel())
        metas.append((name, int(a.size), tuple(a.shape), dt))
        total += int(a.size)
    # Assemble in a ring-pooled (pre-faulted) buffer, NOT np.concatenate:
    # a fresh ~90 MB allocation pays first-touch page faults every call.
    flat = _BATCH_BUF_POOL.acquire(max(total, 1), np.int32)
    off = 0
    for p in parts:
        flat[off:off + p.size] = p
        off += p.size
    layout = tuple((n, shape, dt) for _, n, shape, dt in metas)
    outs = _unbundle_fn(layout)(flat)
    return {name: out for (name, _, _, _), out in zip(metas, outs)}


# ---------------------------------------------------------------------------
# Static per-group geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupGeometry:
    """Static decode geometry for one shape group (hashable jit key).

    Per scan-block-slot tables (slot = position of the block within one MCU,
    in scan order — e.g. 420: Y00 Y01 Y10 Y11 U V):
      flat_off[s]  = component plane base + dy*bw + dx  (block offset)
      row_step[s]  = v_sampling * bw   (flat-block stride per MCU row)
      col_step[s]  = h_sampling       (flat-block stride per MCU column)
      dc_slot[s]/ac_slot[s] = Huffman table slot (0..3)
      comp_of_slot[s] = component index (DC predictor bank)
    """
    batch: int
    mcus_w: int
    flat_off: Tuple[int, ...]
    row_step: Tuple[int, ...]
    col_step: Tuple[int, ...]
    dc_slot: Tuple[int, ...]
    ac_slot: Tuple[int, ...]
    comp_of_slot: Tuple[int, ...]
    ncomp: int
    blocks_w: Tuple[int, ...]
    comp_base: Tuple[int, ...]
    total_blocks: int           # per image, all components

    @classmethod
    def from_params(cls, p: JpegStreamParams, batch: int) -> "GroupGeometry":
        ncomp = len(p.scan_components)
        interleaved = ncomp > 1
        blocks_w, comp_base = [], []
        base = 0
        for ci in range(len(p.components)):
            bh, bw = p.component_block_dims(ci)
            if not interleaved:
                bh = (p.picture_height + 7) // 8
                bw = (p.picture_width + 7) // 8
            blocks_w.append(bw)
            comp_base.append(base)
            base += bh * bw
        flat_off, row_step, col_step = [], [], []
        dc_slot, ac_slot, comp_of_slot = [], [], []
        if interleaved:
            for ci in range(ncomp):
                fc = p.components[ci]
                sc = p.scan_components[ci]
                for v in range(fc.v_sampling_factor):
                    for u in range(fc.h_sampling_factor):
                        flat_off.append(comp_base[ci] + v * blocks_w[ci] + u)
                        row_step.append(fc.v_sampling_factor * blocks_w[ci])
                        col_step.append(fc.h_sampling_factor)
                        dc_slot.append(sc.dc_table_selector)
                        ac_slot.append(sc.ac_table_selector + 2)
                        comp_of_slot.append(ci)
            mcus_w = p.mcus_per_row
        else:
            sc = p.scan_components[0]
            flat_off, row_step, col_step = [0], [blocks_w[0]], [1]
            dc_slot = [sc.dc_table_selector]
            ac_slot = [sc.ac_table_selector + 2]
            comp_of_slot = [0]
            mcus_w = (p.picture_width + 7) // 8
        return cls(batch=batch, mcus_w=mcus_w,
                   flat_off=tuple(flat_off), row_step=tuple(row_step),
                   col_step=tuple(col_step), dc_slot=tuple(dc_slot),
                   ac_slot=tuple(ac_slot), comp_of_slot=tuple(comp_of_slot),
                   ncomp=ncomp, blocks_w=tuple(blocks_w),
                   comp_base=tuple(comp_base), total_blocks=base)


# ---------------------------------------------------------------------------
# The plain jnp wave (the CPU path and the GPU kernel's reference)
# ---------------------------------------------------------------------------

# Symbols decoded per while-loop iteration: unrolling amortizes the loop's
# fixed per-iteration cost, at the price of compile time.
WAVE_UNROLL = 2


def build_wave_decoder(geom: GroupGeometry, n_segs: int, n_words: int,
                       max_steps: int, n_banks: int = 1):
    """Build the raw (un-jitted) ``jnp`` wave decoder for one static
    geometry, over the lane-major word tensor —
    fn(words(R,n_words,128)u32, img_base(R,128), mcu_start(R,128),
       mcu_count(R,128), lentab(4*n_banks,16)u32, values(n_banks*89,)u32
       [, bank(R,128) when n_banks > 1])
      -> (coeffs_flat int16, err bool)
    :func:`build_wave` adapts it to the dense stream.

    n_banks > 1 enables PER-IMAGE Huffman tables: each lane carries a bank
    index selecting its image's table set (the analog of the reference
    forwarding per-image DHTs, vaapi_decoder.cpp:694-834). n_banks is a
    static jit key, so uniform groups compile the exact 1-bank program and
    pay nothing for the feature.

    Layout: lanes are shaped (R, 128) and every one-hot/table dimension
    sits in the middle axis; table lookups are one-hot reductions, and each
    decoded coefficient is appended to step-indexed emission buffers that
    one bulk scatter materializes after the loop.

    max_steps is a hard bound on symbols per lane (min of the block-count
    bound and the real-payload-bits bound), so the kernel runs exactly once;
    lanes still active at exit can only be corrupt streams and are flagged
    as errors on the way out."""

    nslots = len(geom.flat_off)
    ncomp = geom.ncomp
    LANE = 128
    assert n_segs % LANE == 0
    R = n_segs // LANE
    n_slabs = n_words // 8
    out_size = geom.batch * geom.total_blocks * 64
    # (1, T, 1)-shaped iotas / tables broadcast against (R, 1, 128) lanes.

    def mid(arr, dtype=jnp.int32):
        return jnp.asarray(arr, dtype).reshape(1, -1, 1)

    slot_iota = mid(np.arange(nslots))
    len_iota = mid(np.arange(16))
    word8_iota = mid(np.arange(8))
    slab_iota = mid(np.arange(n_slabs))
    vword_iota = mid(np.arange(n_banks * _VAL_WORDS))
    tslot_iota = mid(np.arange(4 * n_banks))
    zig_iota = mid(np.arange(64))
    zigzag_t = mid(ZIGZAG_ORDER)
    lengths16 = mid(np.arange(1, 17), jnp.uint32)
    flat_off_t = mid(geom.flat_off)
    row_step_t = mid(geom.row_step)
    col_step_t = mid(geom.col_step)
    dc_slot_t = mid(geom.dc_slot)
    ac_slot_t = mid(geom.ac_slot)
    val_offs_t = mid(np.tile(_VAL_OFFS, n_banks))  # within-bank offsets
    # comp one-hot from slot one-hot: per component, which slots map to it.
    comp_slots = [
        [s for s in range(nslots) if geom.comp_of_slot[s] == c]
        for c in range(ncomp)
    ]

    def decoder(words, img_base, mcu_start, mcu_count, lentab, values,
                bank=None):
        # words arrives as (R, n_words, 128); state lanes are (R, 128).
        words4 = words.reshape(R, n_slabs, 8, LANE)
        lentabu = lentab.astype(jnp.uint32)          # (4 * n_banks, 16)
        values32 = values.astype(jnp.int32)          # (n_banks * 89,)
        mcus_w = jnp.int32(geom.mcus_w)
        bank4 = None
        bank89 = None
        if n_banks > 1:
            bank4 = (bank * 4).astype(jnp.int32)     # (R, 128)
            bank89 = (bank * _VAL_WORDS).astype(jnp.int32)

        def e(x):
            """Lift a (R, 128) lane array to (R, 1, 128) for table ops."""
            return x[:, None, :]

        def one_symbol(state):
            (acc0, acc1, navail, wcur, slab, slab_id,
             mx, my, mcu_rem, slot, k, dc_pred, err, nstep,
             idx_buf, val_buf) = state
            active = (mcu_rem > 0) & ~err

            # ---- refill: insert one 32-bit word when fewer than 33 bits
            # remain (max consumption per symbol is 16+11=27 bits). ----
            need = navail <= 32
            want_slab = wcur >> 3
            reload = need & (want_slab != slab_id)
            slab_oh = (slab_iota[:, :, None, :] == e(want_slab)[:, :, None, :])
            slab_new = jnp.sum(jnp.where(slab_oh, words4, jnp.uint32(0)),
                               axis=1)                       # (R, 8, 128)
            slab = jnp.where(reload[:, None, :], slab_new, slab)
            slab_id = jnp.where(reload, want_slab, slab_id)
            word_oh = (word8_iota == e(wcur & 7))
            w = jnp.sum(jnp.where(word_oh, slab, jnp.uint32(0)), axis=1)
            na_u = (navail & 31).astype(jnp.uint32)
            hi_or = jnp.where(navail < 32, w >> na_u, jnp.uint32(0))
            lo_or = jnp.where(
                navail == 0, jnp.uint32(0),
                jnp.where(navail == 32, w,
                          w << ((32 - navail) & 31).astype(jnp.uint32)))
            acc0 = jnp.where(need, acc0 | hi_or, acc0)
            acc1 = jnp.where(need, acc1 | lo_or, acc1)
            navail = jnp.where(need, navail + 32, navail)
            wcur = jnp.where(need, wcur + 1, wcur)

            win = acc0  # next 32 bits, MSB-first
            is_dc = k == 0

            # ---- slot-indexed geometry/table selects (one one-hot). ----
            slot_oh = (slot_iota == e(slot))                 # (R, S, 128)

            def sel_slot(table):
                return jnp.sum(jnp.where(slot_oh, table, 0), axis=1)

            tslot = jnp.where(is_dc, sel_slot(dc_slot_t), sel_slot(ac_slot_t))
            if n_banks > 1:
                tslot = tslot + bank4

            # ---- code length + value index via packed lentab. ----
            t_oh = (tslot_iota == e(tslot))             # (R, 4*NB, 128)
            # lentab (4,16) joins as (1, 4, 16, 1) against (R, 4, 1, 128).
            packed16 = jnp.sum(
                jnp.where(t_oh[:, :, None, :],
                          lentabu[None, :, :, None], jnp.uint32(0)),
                axis=1)                                      # (R, 16, 128)
            maxc1 = (packed16 >> 15).astype(jnp.int32)
            base15 = (packed16 & 0x7FFF).astype(jnp.int32)
            cand = (e(win) >> (32 - lengths16)).astype(jnp.int32)
            valid = (cand < maxc1)
            has = jnp.any(valid, axis=1)
            lsel = jnp.argmax(valid, axis=1).astype(jnp.int32)   # 0..15
            oh16 = (len_iota == e(lsel))
            codelen = lsel + 1
            code = jnp.sum(jnp.where(oh16, cand, 0), axis=1)
            base = jnp.sum(jnp.where(oh16, base15, 0), axis=1)
            sym_idx = (code + base) & 0x7FFF
            err = err | (active & ~has)

            # ---- symbol byte from the packed value LUT. ----
            toff = jnp.sum(jnp.where(t_oh, val_offs_t, 0), axis=1)
            flat_sym = jnp.clip(toff + sym_idx, 0, _VAL_TOTAL - 1)
            widx = flat_sym >> 2
            if n_banks > 1:
                widx = widx + bank89
            v_oh = (vword_iota == e(widx))              # (R, NB*89, 128)
            vword = jnp.sum(jnp.where(v_oh, values32[None, :, None], 0),
                            axis=1)
            symbol = (vword >> ((flat_sym & 3) << 3)) & 0xFF

            run = symbol >> 4
            size = symbol & 15

            # ---- extend bits immediately after the code. ----
            ext_shift = (32 - codelen.astype(jnp.uint32)
                         - size.astype(jnp.uint32))
            ext = ((win >> ext_shift)
                   & ((jnp.uint32(1) << size.astype(jnp.uint32)) - 1)
                   ).astype(jnp.int32)
            half = jnp.int32(1) << jnp.maximum(size - 1, 0)
            val = jnp.where(size == 0, 0,
                            jnp.where(ext < half, ext - (half << 1) + 1, ext))

            # ---- DC path. ----
            comp_oh = [functools.reduce(jnp.logical_or,
                                        [slot_oh[:, s, :]
                                         for s in comp_slots[c]])
                       for c in range(ncomp)]
            dc_cur = sum(jnp.where(comp_oh[c], dc_pred[c], 0)
                         for c in range(ncomp))
            dc_new = dc_cur + val
            upd = (active & is_dc)
            dc_pred_next = tuple(
                jnp.where(upd & comp_oh[c], dc_new, dc_pred[c])
                for c in range(ncomp))

            # ---- AC bookkeeping. ----
            is_eob = (~is_dc) & (size == 0) & (run != 15)
            is_zrl = (~is_dc) & (size == 0) & (run == 15)
            k_coeff = jnp.where(is_dc, 0, jnp.minimum(k + run, 63))
            overrun = (~is_dc) & (size > 0) & (k + run > 63)
            writes = active & (is_dc | ((~is_dc) & (size > 0) & ~overrun))
            err = err | (active & overrun)
            write_val = jnp.where(is_dc, dc_new, val).astype(jnp.int16)

            # ---- flat output index (natural order via in-loop zigzag
            # select) ----
            zig_oh = (zig_iota == e(k_coeff))
            k_nat = jnp.sum(jnp.where(zig_oh, zigzag_t, 0), axis=1)
            block_flat = (img_base + sel_slot(flat_off_t)
                          + my * sel_slot(row_step_t)
                          + mx * sel_slot(col_step_t))
            coeff_idx = block_flat * 64 + k_nat
            # Masked lanes target one-past-the-end; the final scatter uses
            # mode='drop' to discard them.
            coeff_idx = jnp.where(writes, coeff_idx, out_size)
            idx_buf = jax.lax.dynamic_update_slice(
                idx_buf, coeff_idx[None], (nstep, 0, 0))
            val_buf = jax.lax.dynamic_update_slice(
                val_buf, write_val[None], (nstep, 0, 0))

            # ---- advance within-block / within-MCU position. ----
            k_next = jnp.where(is_dc, 1,
                               jnp.where(is_eob, 64,
                                         jnp.where(is_zrl, k + 16,
                                                   k + run + 1)))
            block_done = k_next >= 64
            slot_next = jnp.where(block_done, slot + 1, slot)
            mcu_done = slot_next >= nslots
            slot_next = jnp.where(mcu_done, 0, slot_next)
            k_next = jnp.where(block_done, 0, k_next)
            mx_next = jnp.where(mcu_done, mx + 1, mx)
            row_wrap = mx_next >= mcus_w
            mx_next = jnp.where(row_wrap, 0, mx_next)
            my_next = jnp.where(row_wrap, my + 1, my)
            mcu_rem_next = jnp.where(mcu_done, mcu_rem - 1, mcu_rem)

            # ---- consume codelen+size bits (>= 1, <= 27). ----
            n_u = (codelen + size).astype(jnp.uint32)
            acc0n = (acc0 << n_u) | ((acc1 >> 1) >> (31 - n_u))
            acc1n = acc1 << n_u
            acc0 = jnp.where(active, acc0n, acc0)
            acc1 = jnp.where(active, acc1n, acc1)
            navail = jnp.where(active, navail - (codelen + size), navail)

            return (acc0, acc1, navail, wcur, slab, slab_id,
                    jnp.where(active, mx_next, mx),
                    jnp.where(active, my_next, my),
                    jnp.where(active, mcu_rem_next, mcu_rem),
                    jnp.where(active, slot_next, slot),
                    jnp.where(active, k_next, k),
                    dc_pred_next, err, nstep + 1, idx_buf, val_buf)

        def step(state):
            for _ in range(WAVE_UNROLL):
                state = one_symbol(state)
            return state

        def cond(state):
            mcu_rem, err, nstep = state[8], state[12], state[13]
            return jnp.any((mcu_rem > 0) & ~err) & (nstep < max_steps)

        mx0 = mcu_start % mcus_w
        my0 = mcu_start // mcus_w
        lane0 = jnp.zeros((R, LANE), jnp.int32)
        init = (
            lane0.astype(jnp.uint32),                   # acc0
            lane0.astype(jnp.uint32),                   # acc1
            lane0,                                      # navail
            lane0,                                      # wcur
            jnp.zeros((R, 8, LANE), jnp.uint32),        # slab
            lane0 - 1,                                  # slab_id
            mx0.astype(jnp.int32),                      # mx
            my0.astype(jnp.int32),                      # my
            mcu_count.astype(jnp.int32),                # mcu_rem
            lane0,                                      # slot
            lane0,                                      # k
            tuple(lane0 for _ in range(ncomp)),         # dc_pred
            jnp.zeros((R, LANE), jnp.bool_),            # err
            jnp.int32(0),                               # nstep
            jnp.full((max_steps, R, LANE), out_size, jnp.int32),  # idx_buf
            jnp.zeros((max_steps, R, LANE), jnp.int16),  # val_buf
        )
        final = jax.lax.while_loop(cond, step, init)
        mcu_rem, err = final[8], final[12]
        idx_buf, val_buf = final[14], final[15]
        # Lanes still holding MCUs after the hard bound can only be corrupt
        # (a legit lane's symbol count is bounded by its payload bits).
        err = err | (mcu_rem > 0)
        out = jnp.zeros(out_size, jnp.int16)
        out = out.at[idx_buf.reshape(-1)].set(val_buf.reshape(-1), mode="drop")
        return out, err.reshape(-1)

    return decoder


def max_steps_bound(geom: GroupGeometry, packed: PackedDense) -> int:
    """Hard per-lane symbol bound: every symbol consumes >= 1 bit of real
    payload while the lane is legit, and a block yields at most 65 symbols
    (1 DC + up to 63 AC + EOB). Virtual-restart packs carry the EXACT
    per-lane symbol counts from the index walk, which bounds the loop
    tighter than the pessimistic bits bound. Even, so that both waves,
    which decode two symbols per loop iteration, stop at the same step."""
    nslots = len(geom.flat_off)
    block_bound = int(packed.mcu_count.max()) * nslots * 65
    bits_bound = packed.max_seg_bits + 64
    bound = min(block_bound, bits_bound)
    exact = getattr(packed, "max_lane_syms", 0)
    if exact:
        bound = min(bound, exact)
    steps = max(256, min(-(-bound // 256) * 256, block_bound))
    return steps + steps % 2


def wave_backend() -> str:
    """The wave for the current platform: ``'triton'`` (the Pallas kernel
    of ``kernels/wave_triton.py``) on a GPU, ``'jnp'`` (the plain XLA while
    loop) elsewhere."""
    return "triton" if jax.default_backend() == "gpu" else "jnp"


def build_wave(geom: GroupGeometry, n_lanes: int, n_words: int,
               max_steps: int, n_banks: int = 1, backend: str = None):
    """The raw (un-jitted) wave of ``backend`` (default
    :func:`wave_backend`), over the dense
    stream — fn(dense (W,) u32, word_off (L,), img_base (L,),
    mcu_start (L,), mcu_count (L,), lentab (4*n_banks, 16) u32,
    values (n_banks*89,) u32 [, bank (L,) when n_banks > 1])
      -> (coeffs_flat int16, err bool (L,))
    ``coeffs_flat`` may run past B*total_blocks*64 (see
    :func:`unflatten_coefficients`). Un-jitted so the mesh layer can wrap it
    in ``shard_map``."""
    if (backend or wave_backend()) == "triton":
        from ..kernels import wave_triton
        return wave_triton.build_wave_kernel(geom, n_lanes, n_words,
                                             max_steps, n_banks)
    R = n_lanes // 128
    decoder = build_wave_decoder(geom, n_lanes, n_words, max_steps, n_banks)

    def fn(dense, word_off, img_base, mcu_start, mcu_count, lentab, values,
           bank=None):
        idx = (word_off.reshape(R, 1, 128)
               + jnp.arange(n_words, dtype=jnp.int32).reshape(1, n_words, 1))
        words = jnp.take(dense, idx, axis=0, mode="clip")
        lanes = [a.reshape(R, 128) for a in (img_base, mcu_start, mcu_count)]
        extra = (bank.reshape(R, 128),) if n_banks > 1 else ()
        return decoder(words, *lanes, lentab, values, *extra)

    return fn


@functools.lru_cache(maxsize=64)
def _compiled_wave(backend: str, geom: GroupGeometry, n_lanes: int,
                   n_words: int, max_steps: int, n_banks: int):
    """Jitted + cached single-device :func:`build_wave`."""
    return jax.jit(build_wave(geom, n_lanes, n_words, max_steps, n_banks,
                              backend))


def decode_coefficients_on_device(params_list: Sequence[JpegStreamParams],
                                  tables: DeviceScanTables,
                                  packed: PackedDense,
                                  batch: int = 0,
                                  dev=None):
    """Run the wave for one group — exactly one device program, no
    host<->device syncs. Returns (coeffs_flat jnp int16, err device bool
    array (n_lanes,), geometry); ``coeffs_flat`` holds at least
    B*total_blocks*64 entries. ``batch`` may exceed len(params_list) to
    reuse a bucketed program.

    ``dev``: optional {name: device array} from stage_small_args — when a
    key (dense/word_off/img_base/mcu_start/mcu_count/lane_bank/lentab/
    values) is present, its pre-staged device array is used instead of
    uploading the host copy."""
    geom = GroupGeometry.from_params(params_list[0],
                                     batch or len(params_list))
    max_steps = max_steps_bound(geom, packed)
    dev = dev or {}
    n_banks = getattr(tables, "n_banks", 1)
    fn = _compiled_wave(wave_backend(), geom, packed.n_lanes, packed.n_words,
                        max_steps, n_banks)
    args = [dev.get(name, getattr(packed, name))
            for name in ("dense", "word_off", "img_base", "mcu_start",
                         "mcu_count")]
    args += [dev.get("lentab", tables.lentab),
             dev.get("values", tables.values)]
    if n_banks > 1:
        args.append(dev.get("lane_bank", packed.lane_bank))
    coeffs, err = fn(*args)
    return coeffs, err, geom


def unflatten_coefficients(coeffs_flat, geom: GroupGeometry,
                           params: JpegStreamParams):
    """Split the flat coefficient tensor into per-component
    (B, bh, bw, 64) views (device arrays, no copy beyond reshape). Entries
    past B*total_blocks*64 (the GPU kernel's spare tail) are dropped."""
    out = []
    size = geom.batch * geom.total_blocks * 64
    per_img = coeffs_flat[:size].reshape(geom.batch, geom.total_blocks * 64)
    for ci in range(len(geom.comp_base)):
        base = geom.comp_base[ci]
        bw = geom.blocks_w[ci]
        nxt = (geom.comp_base[ci + 1] if ci + 1 < len(geom.comp_base)
               else geom.total_blocks)
        nblocks = nxt - base
        bh = nblocks // bw
        comp = per_img[:, base * 64:nxt * 64].reshape(geom.batch, bh, bw, 64)
        out.append(comp)
    return out
