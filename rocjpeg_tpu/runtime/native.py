"""ctypes binding for the native host entropy decoder (csrc/).

Loads ``librocjpeg_host.so`` (building it with g++ on first use if absent)
and exposes :func:`decode_scan` with the same signature/semantics as the
Python oracle ``rocjpeg_tpu.core.entropy.decode_scan`` — same outputs
bit-for-bit; errors surface as RocJpegError(BAD_JPEG).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List

import numpy as np

from ..core.bitstream import JpegStreamParams
from ..status import RocJpegError, Status

_MAXC = 3
_MAXT = 4


class _RjtScanJob(ctypes.Structure):
    _fields_ = [
        ("scan", ctypes.c_char_p),
        ("scan_len", ctypes.c_long),
        ("restart_interval", ctypes.c_int),
        ("num_components", ctypes.c_int),
        ("interleaved", ctypes.c_int),
        ("mcus_w", ctypes.c_int),
        ("total_mcus", ctypes.c_int),
        ("h_samp", ctypes.c_int * _MAXC),
        ("v_samp", ctypes.c_int * _MAXC),
        ("dc_table", ctypes.c_int * _MAXC),
        ("ac_table", ctypes.c_int * _MAXC),
        ("dc_bits", ctypes.c_void_p * _MAXT),
        ("dc_values", ctypes.c_void_p * _MAXT),
        ("ac_bits", ctypes.c_void_p * _MAXT),
        ("ac_values", ctypes.c_void_p * _MAXT),
        ("out", ctypes.c_void_p * _MAXC),
        ("out_bw", ctypes.c_int * _MAXC),
        ("num_threads", ctypes.c_int),
    ]


_ERROR_NAMES = {
    1: "bad Huffman table", 2: "invalid Huffman code",
    3: "AC index overflow", 4: "scan data exhausted", 5: "missing restart segments",
}

_PARSE_ERRORS = {
    10: "invalid JPEG: missing SOI", 11: "corrupt marker segment: truncated",
    12: "invalid number of JPEG components",
    13: "invalid quantization table id",
    14: "16-bit quantization table is not supported",
    15: "invalid Huffman table", 16: "didn't find any Huffman table",
    17: "didn't find any quantization table",
    18: "didn't find the SOS marker", 19: "invalid sampling factors",
    20: "invalid size for DRI marker",
    21: "component id mismatch between SOS and SOF",
}


class _RjtParsedHeader(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32), ("height", ctypes.c_int32),
        ("num_components", ctypes.c_int32),
        ("comp_id", ctypes.c_int32 * 4), ("h_samp", ctypes.c_int32 * 4),
        ("v_samp", ctypes.c_int32 * 4), ("quant_sel", ctypes.c_int32 * 4),
        ("qtab", (ctypes.c_uint8 * 64) * 4),
        ("load_qtab", ctypes.c_uint8 * 4),
        ("dc_bits", (ctypes.c_uint8 * 16) * 2),
        ("dc_vals", (ctypes.c_uint8 * 12) * 2),
        ("ac_bits", (ctypes.c_uint8 * 16) * 2),
        ("ac_vals", (ctypes.c_uint8 * 162) * 2),
        ("load_huff", ctypes.c_uint8 * 2),
        ("num_scan_components", ctypes.c_int32),
        ("scan_comp_sel", ctypes.c_int32 * 4),
        ("scan_dc", ctypes.c_int32 * 4), ("scan_ac", ctypes.c_int32 * 4),
        ("restart_interval", ctypes.c_int32),
        ("scan_offset", ctypes.c_int64), ("scan_end", ctypes.c_int64),
        ("subsampling", ctypes.c_int32), ("num_mcus", ctypes.c_int64),
    ]

class _RjtIndexJob(ctypes.Structure):
    _fields_ = [
        ("scan", ctypes.c_char_p),
        ("scan_len", ctypes.c_long),
        ("num_components", ctypes.c_int),
        ("interleaved", ctypes.c_int),
        ("total_mcus", ctypes.c_int),
        ("min_symbols", ctypes.c_int),
        ("h_samp", ctypes.c_int * _MAXC),
        ("v_samp", ctypes.c_int * _MAXC),
        ("dc_table", ctypes.c_int * _MAXC),
        ("ac_table", ctypes.c_int * _MAXC),
        ("dc_bits", ctypes.c_void_p * _MAXT),
        ("dc_values", ctypes.c_void_p * _MAXT),
        ("ac_bits", ctypes.c_void_p * _MAXT),
        ("ac_values", ctypes.c_void_p * _MAXT),
        ("clean", ctypes.c_void_p),
        ("bit_off", ctypes.c_void_p),
        ("dc_out", ctypes.c_void_p),
        ("mcu_idx", ctypes.c_void_p),
        ("sym_count", ctypes.c_void_p),
        ("n_records", ctypes.c_long),
        ("n_found", ctypes.c_long),
    ]


class _RjtGeomJob(ctypes.Structure):
    """Mirrors csrc RjtGeomJob: one image's index-walk record set plus its
    destination lane range, for the native lane-geometry bookkeeping."""
    _fields_ = [
        ("bo", ctypes.c_void_p),
        ("dc", ctypes.c_void_p),
        ("mi", ctypes.c_void_p),
        ("sc", ctypes.c_void_p),
        ("n_rec", ctypes.c_int64),
        ("end_bit", ctypes.c_int64),
        ("end_mcu", ctypes.c_int32),
        ("lane_start", ctypes.c_int32),
        ("img_base", ctypes.c_int32),
        ("bank", ctypes.c_int32),
        ("img_row", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
    ]


# ROCJPEG_HOST_LIB overrides the library path — used by `make test-asan` to
# load the -fsanitize=address build (the reference ships an ASAN package
# variant, CMakeLists.txt:160,200-206).
_LIB_PATH = os.environ.get("ROCJPEG_HOST_LIB") or os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "librocjpeg_host.so")


# Why the library is absent, when it is (the build's or the loader's error).
LOAD_ERROR = None


def _load():
    global LOAD_ERROR
    if not os.path.exists(_LIB_PATH):
        try:
            import importlib.util
            spec = importlib.util.spec_from_file_location(
                "rjt_csrc_build",
                os.path.join(os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__)))),
                    "csrc", "build.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.build(verbose=False)
        except Exception as exc:  # no compiler, compile error, ...
            LOAD_ERROR = f"building {_LIB_PATH} failed: {exc!r}"
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.rjt_decode_scan.argtypes = [ctypes.POINTER(_RjtScanJob)]
        lib.rjt_decode_scan.restype = ctypes.c_int
        if hasattr(lib, "rjt_parse"):
            lib.rjt_parse.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                      ctypes.POINTER(_RjtParsedHeader)]
            lib.rjt_parse.restype = ctypes.c_int
        if hasattr(lib, "rjt_seg_lens"):
            lib.rjt_seg_lens.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_int), ctypes.c_long]
            lib.rjt_seg_lens.restype = ctypes.c_long
            lib.rjt_pack_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_long, ctypes.c_long]
            lib.rjt_pack_rows.restype = ctypes.c_long
        if hasattr(lib, "rjt_seg_offsets"):
            lib.rjt_seg_offsets.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_long]
            lib.rjt_seg_offsets.restype = ctypes.c_long
        if hasattr(lib, "rjt_pack_dense"):
            lib.rjt_pack_dense.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_long]
            lib.rjt_pack_dense.restype = ctypes.c_long
        if hasattr(lib, "rjt_index_scan"):
            lib.rjt_index_scan.argtypes = [ctypes.POINTER(_RjtIndexJob)]
            lib.rjt_index_scan.restype = ctypes.c_long
            lib.rjt_index_scan2.argtypes = [
                ctypes.POINTER(_RjtIndexJob), ctypes.POINTER(_RjtIndexJob),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
            lib.rjt_index_scan2.restype = ctypes.c_long
            lib.rjt_pack_bits.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_long]
            lib.rjt_pack_bits.restype = None
            lib.rjt_index_scan8.argtypes = [
                ctypes.POINTER(ctypes.POINTER(_RjtIndexJob)),
                ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
            lib.rjt_index_scan8.restype = ctypes.c_long
            if hasattr(lib, "rjt_index_scan32"):
                lib.rjt_index_scan32.argtypes = [
                    ctypes.POINTER(ctypes.POINTER(_RjtIndexJob)),
                    ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
                lib.rjt_index_scan32.restype = ctypes.c_long
            if hasattr(lib, "rjt_index_scan16"):
                lib.rjt_index_scan16.argtypes = [
                    ctypes.POINTER(ctypes.POINTER(_RjtIndexJob)),
                    ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
                lib.rjt_index_scan16.restype = ctypes.c_long
            if hasattr(lib, "rjt_index_scan16_available"):
                lib.rjt_index_scan16_available.argtypes = []
                lib.rjt_index_scan16_available.restype = ctypes.c_long
        if hasattr(lib, "rjt_unstuff"):
            lib.rjt_unstuff.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                        ctypes.c_void_p]
            lib.rjt_unstuff.restype = ctypes.c_long
        if hasattr(lib, "rjt_lane_geometry"):
            lib.rjt_record_maxes.argtypes = [
                ctypes.POINTER(_RjtGeomJob), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            lib.rjt_record_maxes.restype = None
            lib.rjt_lane_geometry.argtypes = [
                ctypes.POINTER(_RjtGeomJob), ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64]
            lib.rjt_lane_geometry.restype = None
        return lib
    except OSError as exc:
        LOAD_ERROR = f"loading {_LIB_PATH} failed: {exc}"
        return None


_lib = _load()
AVAILABLE = _lib is not None


def decode_scan(params: JpegStreamParams,
                num_threads: int = 0) -> List[np.ndarray]:
    """Native entropy decode; drop-in for core.entropy.decode_scan.

    num_threads=0 uses all host cores for restart-segmented scans.
    """
    if _lib is None:  # pragma: no cover
        raise RuntimeError("native library unavailable")
    ncomp_scan = len(params.scan_components)
    if ncomp_scan == 0 or not params.components:
        raise RocJpegError(Status.BAD_JPEG, "no scan components")

    job = _RjtScanJob()
    scan = params.slice_data
    job.scan = scan
    job.scan_len = len(scan)
    job.restart_interval = params.restart_interval
    job.num_components = ncomp_scan
    interleaved = ncomp_scan > 1
    job.interleaved = int(interleaved)
    if interleaved:
        job.mcus_w = params.mcus_per_row
        job.total_mcus = params.num_mcus
    else:
        bw = (params.picture_width + 7) // 8
        bh = (params.picture_height + 7) // 8
        job.mcus_w = bw
        job.total_mcus = bw * bh

    outputs = []
    keepalive = []
    for ci in range(len(params.components)):
        fc = params.components[ci]
        out = np.zeros(params.component_block_dims(ci) + (64,), np.int16)
        outputs.append(out)
        if ci < ncomp_scan:
            sc = params.scan_components[ci]
            job.h_samp[ci] = fc.h_sampling_factor
            job.v_samp[ci] = fc.v_sampling_factor
            job.dc_table[ci] = sc.dc_table_selector
            job.ac_table[ci] = sc.ac_table_selector
            job.out[ci] = out.ctypes.data
            job.out_bw[ci] = out.shape[1]

    for tid in range(min(_MAXT, len(params.huffman_tables))):
        if not params.load_huffman_table[tid]:
            continue
        t = params.huffman_tables[tid]
        for arr, field in ((t.num_dc_codes, "dc_bits"), (t.dc_values, "dc_values"),
                           (t.num_ac_codes, "ac_bits"), (t.ac_values, "ac_values")):
            a = np.ascontiguousarray(arr, np.uint8)
            keepalive.append(a)
            getattr(job, field)[tid] = a.ctypes.data

    # Validate selectors point at loaded tables (C side checks pointers).
    for sc in params.scan_components:
        for tid in (sc.dc_table_selector, sc.ac_table_selector):
            if tid >= len(params.huffman_tables) or not params.load_huffman_table[tid]:
                raise RocJpegError(Status.BAD_JPEG, f"huffman table {tid} not loaded")

    job.num_threads = num_threads or (os.cpu_count() or 1)

    rc = _lib.rjt_decode_scan(ctypes.byref(job))
    if rc != 0:
        raise RocJpegError(Status.BAD_JPEG,
                           _ERROR_NAMES.get(rc, f"native decode error {rc}"))
    return outputs


PACK_AVAILABLE = AVAILABLE and hasattr(_lib, "rjt_seg_lens")
PARSE_AVAILABLE = AVAILABLE and hasattr(_lib, "rjt_parse")


def parse_header(data: bytes):
    """Native JPEG header parse; fills a JpegStreamParams exactly like the
    Python parser (core/bitstream.py). Raises RocJpegError(BAD_JPEG) with
    the Python parser's message strings."""
    from ..core import bitstream as bs

    hdr = _RjtParsedHeader()
    rc = _lib.rjt_parse(data, len(data), ctypes.byref(hdr))
    if rc != 0:
        raise RocJpegError(Status.BAD_JPEG,
                           _PARSE_ERRORS.get(rc, f"parse error {rc}"))
    p = bs.JpegStreamParams()
    p.picture_width = hdr.width
    p.picture_height = hdr.height
    p.num_components = hdr.num_components
    p.components = [
        bs.FrameComponent(component_id=hdr.comp_id[i],
                          h_sampling_factor=hdr.h_samp[i],
                          v_sampling_factor=hdr.v_samp[i],
                          quantiser_table_selector=hdr.quant_sel[i])
        for i in range(hdr.num_components)
    ]
    # One bulk copy of the struct; numpy views into it by field offset
    # (per-field ctypes->numpy conversion costs ~10us each).
    raw = bytearray(bytes(hdr))
    H = _RjtParsedHeader

    def view(field, count, shape=None):
        a = np.frombuffer(raw, np.uint8, count, getattr(H, field).offset)
        return a.reshape(shape) if shape else a

    p.quantiser_tables = view("qtab", 256, (4, 64))
    p.load_quantiser_table = view("load_qtab", 4)
    dc_bits = view("dc_bits", 32, (2, 16))
    dc_vals = view("dc_vals", 24, (2, 12))
    ac_bits = view("ac_bits", 32, (2, 16))
    ac_vals = view("ac_vals", 324, (2, 162))
    for tid in range(2):
        t = p.huffman_tables[tid]
        t.num_dc_codes = dc_bits[tid]
        t.dc_values = dc_vals[tid]
        t.num_ac_codes = ac_bits[tid]
        t.ac_values = ac_vals[tid]
    p.load_huffman_table = view("load_huff", 2)
    p.scan_components = [
        bs.ScanComponent(component_selector=hdr.scan_comp_sel[i],
                         dc_table_selector=hdr.scan_dc[i],
                         ac_table_selector=hdr.scan_ac[i])
        for i in range(hdr.num_scan_components)
    ]
    p.restart_interval = hdr.restart_interval
    p.num_mcus = int(hdr.num_mcus)
    p.slice_data = data[hdr.scan_offset:hdr.scan_end]
    from ..types import ChromaSubsampling
    try:
        p.chroma_subsampling = ChromaSubsampling(hdr.subsampling)
    except ValueError:
        # Unclassifiable sampling patterns parse to UNKNOWN (a value, not an
        # error — reference parser.cpp:432-470 rejects at decode time).
        p.chroma_subsampling = ChromaSubsampling.CSS_UNKNOWN
    return p


def seg_lens(scan: bytes, max_segs: int) -> np.ndarray:
    """Clean (unstuffed) byte length of each restart segment of a scan."""
    out = np.zeros(max_segs, np.int32)
    n = _lib.rjt_seg_lens(scan, len(scan),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                          max_segs)
    return out[:min(int(n), max_segs)], int(n)


def pack_rows(scan: bytes, words: np.ndarray, lane0: int, n_words: int,
              max_segs: int) -> int:
    """Write a scan's segments into the (R, n_words, 128)-uint32 transposed
    word buffer starting at global lane ``lane0`` (GIL released)."""
    return int(_lib.rjt_pack_rows(scan, len(scan),
                                  ctypes.c_void_p(words.ctypes.data),
                                  lane0, n_words, max_segs))


def seg_offsets(scan: bytes, max_segs: int):
    """Clean lengths AND raw byte offsets of each restart segment (the raw
    offset lets a packer start mid-scan — byte stuffing is context-free).
    Returns (lens int32 (n,), raw_off int64 (n,), found)."""
    lens = np.zeros(max_segs, np.int32)
    raw = np.zeros(max_segs, np.int64)
    n = _lib.rjt_seg_offsets(scan, len(scan),
                             ctypes.c_void_p(lens.ctypes.data),
                             ctypes.c_void_p(raw.ctypes.data), max_segs)
    m = min(int(n), max_segs)
    return lens[:m], raw[:m], int(n)


SEG_OFFSETS_AVAILABLE = AVAILABLE and hasattr(_lib, "rjt_seg_offsets")


def pack_dense(scan: bytes, dense: np.ndarray, word_off: np.ndarray,
               max_segs: int) -> int:
    """Write a scan's unstuffed segments word-aligned into the dense uint32
    stream at precomputed per-segment word offsets (GIL released). ``dense``
    must be zero-initialized (partial tail words rely on it)."""
    return int(_lib.rjt_pack_dense(
        scan, len(scan), ctypes.c_void_p(dense.ctypes.data),
        ctypes.c_void_p(np.ascontiguousarray(word_off, np.int32).ctypes.data),
        max_segs))


DENSE_PACK_AVAILABLE = AVAILABLE and hasattr(_lib, "rjt_pack_dense")
INDEX_AVAILABLE = AVAILABLE and hasattr(_lib, "rjt_index_scan")


def index_job_capacities(params: JpegStreamParams, min_symbols: int):
    """(clean_bytes, n_records) buffer capacities one index job needs —
    the pooling contract for callers that reuse buffers across calls
    (ops/device_entropy._IdxBufPool)."""
    ncomp_scan = len(params.scan_components)
    if ncomp_scan > 1:
        total = params.num_mcus
    else:
        total = (((params.picture_width + 7) // 8)
                 * (((params.picture_height + 7) // 8)))
    scan = params.slice_data
    n_rec = min(total, len(scan) * 8 // max(1, min_symbols)) + 2
    return len(scan) + 8, n_rec


def _build_index_job(params: JpegStreamParams, min_symbols: int, bufs=None):
    """Fill an _RjtIndexJob + output buffers for one stream. Returns
    (job, clean, bit_off, dc, mcu_idx, sym_count, keepalive).

    ``bufs`` optionally supplies preallocated
    (clean u8, bit_off i64, dc i32 (n,3), mcu_idx i32, sym_count i32)
    arrays with capacities >= index_job_capacities(...); the native
    unstuffer zeroes the walkers' 8-byte slack itself, so pooled (dirty)
    buffers are safe. Views of these buffers are returned — callers that
    pool MUST NOT let results outlive the pool's reuse cycle."""
    ncomp_scan = len(params.scan_components)
    interleaved = ncomp_scan > 1
    if interleaved:
        total = params.num_mcus
    else:
        total = (((params.picture_width + 7) // 8)
                 * (((params.picture_height + 7) // 8)))
    # Record-capacity bound: one record per >= min_symbols symbols, each
    # symbol consumes >= 1 bit of scan payload; also at most one per MCU.
    scan = params.slice_data
    n_rec = min(total, len(scan) * 8 // max(1, min_symbols)) + 2

    job = _RjtIndexJob()
    job.scan = scan
    job.scan_len = len(scan)
    job.num_components = ncomp_scan
    job.interleaved = int(interleaved)
    job.total_mcus = total
    job.min_symbols = min_symbols
    keepalive = [scan]
    for ci in range(ncomp_scan):
        fc = params.components[ci]
        sc = params.scan_components[ci]
        job.h_samp[ci] = fc.h_sampling_factor
        job.v_samp[ci] = fc.v_sampling_factor
        job.dc_table[ci] = sc.dc_table_selector
        job.ac_table[ci] = sc.ac_table_selector
    for tid in range(min(_MAXT, len(params.huffman_tables))):
        if not params.load_huffman_table[tid]:
            continue
        t = params.huffman_tables[tid]
        for arr, field in ((t.num_dc_codes, "dc_bits"),
                           (t.dc_values, "dc_values"),
                           (t.num_ac_codes, "ac_bits"),
                           (t.ac_values, "ac_values")):
            a = np.ascontiguousarray(arr, np.uint8)
            keepalive.append(a)
            getattr(job, field)[tid] = a.ctypes.data

    if bufs is not None:
        clean, bit_off, dc, mcu_idx, sym_count = bufs
        assert len(clean) >= len(scan) + 8 and len(bit_off) >= n_rec
        clean = clean[:len(scan) + 8]
    else:
        # 8 bytes of zero slack: the branchless walker's refill reads 4
        # bytes at a clamped offset <= clean_len (rjt_unstuff re-zeroes
        # the slack each call, so this np.zeros is belt-and-braces).
        clean = np.zeros(len(scan) + 8, np.uint8)
        bit_off = np.empty(n_rec, np.int64)
        dc = np.empty((n_rec, 3), np.int32)
        mcu_idx = np.empty(n_rec, np.int32)
        sym_count = np.empty(n_rec, np.int32)
    job.clean = clean.ctypes.data
    job.bit_off = bit_off.ctypes.data
    job.dc_out = dc.ctypes.data
    job.mcu_idx = mcu_idx.ctypes.data
    job.sym_count = sym_count.ctypes.data
    job.n_records = n_rec
    return job, clean, bit_off, dc, mcu_idx, sym_count, keepalive


def index_scan(params: JpegStreamParams, min_symbols: int):
    """Virtual-restart index pass for a DRI=0 scan (csrc rjt_index_scan):
    walks the Huffman symbol stream recording the clean-stream bit offset,
    MCU index, and DC predictor values at the first MCU boundary after
    every >= ``min_symbols`` decoded symbols (symbol-balanced lanes).

    Returns (clean uint8, bit_off int64 (n,), dc int32 (n, 3),
    mcu_idx int32 (n,), sym_count int32 (n,)). Raises
    RocJpegError(BAD_JPEG) if the walk hits an invalid code — the caller
    falls back to the host decode path, which reports precisely.
    """
    job, clean, bit_off, dc, mcu_idx, sym_count, _keep = _build_index_job(
        params, min_symbols)
    rc = int(_lib.rjt_index_scan(ctypes.byref(job)))
    if rc < 0:
        raise RocJpegError(Status.BAD_JPEG,
                           _ERROR_NAMES.get(-rc, f"native index error {-rc}"))
    n = job.n_found
    return clean[:rc], bit_off[:n], dc[:n], mcu_idx[:n], sym_count[:n]


def index_scan2(pa: JpegStreamParams, pb: JpegStreamParams,
                min_symbols: int):
    """Dual-stream index pass (csrc rjt_index_scan2): walks two same-shape
    streams symbol-interleaved so the core overlaps their independent
    dependency chains. Returns a list of two
    (clean, bit_off, dc, mcu_idx, sym_count) tuples."""
    ja, ca, boa, dca, mia, sca, _ka = _build_index_job(pa, min_symbols)
    jb, cb, bob, dcb, mib, scb, _kb = _build_index_job(pb, min_symbols)
    la = ctypes.c_long(0)
    lb = ctypes.c_long(0)
    rc = int(_lib.rjt_index_scan2(ctypes.byref(ja), ctypes.byref(jb),
                                  ctypes.byref(la), ctypes.byref(lb)))
    if rc < 0:
        raise RocJpegError(Status.BAD_JPEG,
                           _ERROR_NAMES.get(-rc, f"native index error {-rc}"))
    na, nb = ja.n_found, jb.n_found
    return [(ca[:la.value], boa[:na], dca[:na], mia[:na], sca[:na]),
            (cb[:lb.value], bob[:nb], dcb[:nb], mib[:nb], scb[:nb])]


def _index_scan_simd(params_list, min_symbols: int, n: int, fn,
                     bufs_list=None):
    """Shared wrapper for the SIMD n-stream index walkers: builds the n
    jobs, runs the native walker, and slices the per-job outputs. Returns
    None on -RJT_BAD_SEGMENTS (SIMD tier unavailable / non-uniform jobs) —
    callers fall back to the next-narrower walker. ``bufs_list`` optionally
    supplies per-job pooled buffers (see _build_index_job)."""
    built = [_build_index_job(p, min_symbols,
                              bufs_list[i] if bufs_list else None)
             for i, p in enumerate(params_list)]
    jobs = (ctypes.POINTER(_RjtIndexJob) * n)(
        *[ctypes.pointer(b[0]) for b in built])
    clean_lens = (ctypes.c_long * n)()
    rc = int(fn(jobs, n, clean_lens))
    if rc == -5:  # RJT_BAD_SEGMENTS
        return None
    if rc < 0:
        raise RocJpegError(Status.BAD_JPEG,
                           _ERROR_NAMES.get(-rc, f"native index error {-rc}"))
    out = []
    for i, (job, clean, bit_off, dc, mcu_idx, sym_count, _k) in enumerate(built):
        nf = job.n_found
        out.append((clean[:clean_lens[i]], bit_off[:nf], dc[:nf],
                    mcu_idx[:nf], sym_count[:nf]))
    return out


def index_scan8(params_list, min_symbols: int, bufs_list=None):
    """SIMD 8-stream index pass (csrc rjt_index_scan8, AVX2): eight
    same-shape, same-table streams walked in vector lanes — the wave
    kernel's lane model on the host CPU. Returns a list of eight
    (clean, bit_off, dc, mcu_idx, sym_count) tuples, or None when the SIMD
    path is unavailable (no AVX2 / non-uniform jobs) — callers fall back
    to the scalar pair walker."""
    if len(params_list) != 8 or not hasattr(_lib, "rjt_index_scan8"):
        return None
    return _index_scan_simd(params_list, min_symbols, 8,
                            _lib.rjt_index_scan8, bufs_list)


@functools.lru_cache(maxsize=1)
def index_scan16_available() -> bool:
    """Whether the AVX-512 16-stream walker can run on this host (static
    CPU probe; lets callers pick a chunk width once instead of building 16
    jobs per batch only to be rejected)."""
    if not hasattr(_lib, "rjt_index_scan16_available"):
        return False
    return bool(_lib.rjt_index_scan16_available())


def index_scan16(params_list, min_symbols: int, bufs_list=None):
    """AVX-512 16-stream index pass (csrc rjt_index_scan16): sixteen
    same-shape, same-table streams walked in vector lanes. Returns a list
    of sixteen (clean, bit_off, dc, mcu_idx, sym_count) tuples, or None
    when the path is unavailable (no AVX-512 / non-uniform jobs) — callers
    fall back to the 8-lane walker."""
    if (len(params_list) != 16 or not hasattr(_lib, "rjt_index_scan16")
            or not index_scan16_available()):
        return None
    return _index_scan_simd(params_list, min_symbols, 16,
                            _lib.rjt_index_scan16, bufs_list)


def index_scan32(params_list, min_symbols: int, bufs_list=None):
    """32-stream index pass (csrc rjt_index_scan32): TWO 16-lane AVX-512
    groups interleaved on one core, overlapping the two groups' gather
    dependency chains in the out-of-order window (~1.5x one group's
    aggregate; see docs/performance.md). Returns a list of 32
    (clean, bit_off, dc, mcu_idx, sym_count) tuples, or None when the
    path is unavailable — callers fall back to two 16-lane walks."""
    if (len(params_list) != 32 or not hasattr(_lib, "rjt_index_scan32")
            or not index_scan16_available()):
        return None
    return _index_scan_simd(params_list, min_symbols, 32,
                            _lib.rjt_index_scan32, bufs_list)


def pack_bits(clean: np.ndarray, dense: np.ndarray, word_off: np.ndarray,
              bit_start: np.ndarray, bit_end: np.ndarray) -> None:
    """Pack per-lane bit ranges of a clean stream into the dense word stream
    (each lane's first bit lands at bit 31 of its first word; GIL released)."""
    _lib.rjt_pack_bits(
        ctypes.c_void_p(clean.ctypes.data), len(clean),
        ctypes.c_void_p(dense.ctypes.data),
        ctypes.c_void_p(np.ascontiguousarray(word_off, np.int32).ctypes.data),
        ctypes.c_void_p(np.ascontiguousarray(bit_start, np.int64).ctypes.data),
        ctypes.c_void_p(np.ascontiguousarray(bit_end, np.int64).ctypes.data),
        len(word_off))


def geometry_available() -> bool:
    """Whether the native lane-geometry bookkeeping (rjt_lane_geometry) is
    in the loaded library (absent only with a stale .so)."""
    return _lib is not None and hasattr(_lib, "rjt_lane_geometry")


def build_geom_jobs(meta):
    """Build the ctypes RjtGeomJob array for record_maxes/lane_geometry.

    ``meta``: per image, a tuple (bo int64 (n,), dc int32 (n, 3), mi int32
    (n,), sc int32 (n,), end_bit, end_mcu, lane_start, img_base, bank,
    img_row); arrays must be C-contiguous (slices of the walkers' record
    buffers are). The returned array holds RAW pointers — the caller must
    keep the arrays alive across the native calls."""
    n = len(meta)
    arr = (_RjtGeomJob * n)()
    for k, (bo, dc, mi, sc, eb, em, ls, ib, bank, row) in enumerate(meta):
        assert bo.dtype == np.int64 and bo.flags.c_contiguous
        assert dc.dtype == np.int32 and dc.flags.c_contiguous
        assert mi.dtype == np.int32 and mi.flags.c_contiguous
        assert sc.dtype == np.int32 and sc.flags.c_contiguous
        j = arr[k]
        j.bo = bo.ctypes.data
        j.dc = dc.ctypes.data
        j.mi = mi.ctypes.data
        j.sc = sc.ctypes.data
        j.n_rec = len(bo)
        j.end_bit = int(eb)
        j.end_mcu = int(em)
        j.lane_start = int(ls)
        j.img_base = int(ib)
        j.bank = int(bank)
        j.img_row = int(row)
    return arr


def record_maxes(jobs_arr, n: int):
    """Native pass over all kept records: (max lane bit-span, max lane
    symbol count) — the packer's buffer-sizing inputs. GIL released."""
    mb = ctypes.c_int64(0)
    ms = ctypes.c_int64(0)
    _lib.rjt_record_maxes(jobs_arr, n, ctypes.byref(mb), ctypes.byref(ms))
    return int(mb.value), int(ms.value)


def lane_geometry(jobs_arr, n: int, lane_words, bit_starts, bit_ends,
                  img_base, mcu_start, mcu_count, lane_bank, dc_flat,
                  lane_of_mcu, total_mcus: int) -> None:
    """Fill the per-lane geometry arrays + lane_of_mcu gather key from the
    walk records, in native code with the GIL released (the Python loop
    this replaces serialized the submit threads). Output arrays must be
    pre-zeroed and sized to the padded lane count."""
    assert lane_words.dtype == np.int64 and bit_starts.dtype == np.int64
    assert bit_ends.dtype == np.int64
    for a in (img_base, mcu_start, mcu_count, lane_bank, dc_flat,
              lane_of_mcu):
        assert a.dtype == np.int32 and a.flags.c_contiguous
    _lib.rjt_lane_geometry(
        jobs_arr, n,
        ctypes.c_void_p(lane_words.ctypes.data),
        ctypes.c_void_p(bit_starts.ctypes.data),
        ctypes.c_void_p(bit_ends.ctypes.data),
        ctypes.c_void_p(img_base.ctypes.data),
        ctypes.c_void_p(mcu_start.ctypes.data),
        ctypes.c_void_p(mcu_count.ctypes.data),
        ctypes.c_void_p(lane_bank.ctypes.data),
        ctypes.c_void_p(dc_flat.ctypes.data),
        ctypes.c_void_p(lane_of_mcu.ctypes.data),
        ctypes.c_int64(total_mcus))


def unstuff(scan: bytes) -> np.ndarray:
    """Remove JPEG byte stuffing (0xFF00 -> 0xFF) from a DRI=0 scan.
    Returns the clean uint8 array (with 8 zero slack bytes of capacity
    beyond the returned view). Raises BAD_JPEG if a real RSTn marker is
    embedded. GIL released during the scan."""
    out = np.zeros(len(scan) + 8, np.uint8)
    n = int(_lib.rjt_unstuff(scan, len(scan),
                             ctypes.c_void_p(out.ctypes.data)))
    if n < 0:
        raise RocJpegError(Status.BAD_JPEG,
                           "restart marker embedded in DRI=0 scan")
    return out[:n]


UNSTUFF_AVAILABLE = AVAILABLE and hasattr(_lib, "rjt_unstuff")
