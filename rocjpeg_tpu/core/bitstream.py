"""Host-side JPEG bitstream (JFIF) marker parser.

Rebuild of the reference's CPU parser
(``src/rocjpeg_parser.{h,cpp}``): parses a baseline-DCT JPEG into the
parameter set the decode engine consumes. Behavioral parity notes:

- SOI must be the first two bytes (parser.cpp:64-67).
- Marker scan loop until SOS; unknown/unhandled markers (APPn, COM,
  progressive SOFs, ...) are skipped by their length field (parser.cpp:74-109).
- DHT and DQT are required (parser.cpp:111-118).
- 16-bit quantization tables are rejected (parser.cpp:230-233).
- MCU count derives from component-0 sampling factors (parser.cpp:197-198).
- Chroma subsampling classified from the h/v sampling-factor pattern table,
  including the multi-variant 444/422/400 patterns (parser.cpp:432-470).
- Scan (slice) data = [first byte after the SOS header .. EOI marker), found
  by a linear scan for 0xFFD9; when EOI is absent the remainder of the buffer
  is used, exactly like ParseEOI (parser.cpp:400-416).

Beyond the reference, the parser also records what the VCN ASIC handled in
silicon and this framework needs explicitly: per-scan-component table
selectors and the restart interval feed the restart-segment index used by
the parallel entropy decoder (see ``core/entropy.py``).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional

import numpy as np

from ..status import RocJpegError, Status
from ..types import ChromaSubsampling

# Marker bytes (second byte after 0xFF); mirrors JpegMarkers (parser.h:46-54).
SOI = 0xD8
SOF0 = 0xC0  # baseline DCT — the only SOF the reference parses
DHT = 0xC4
DQT = 0xDB
DRI = 0xDD
SOS = 0xDA
EOI = 0xD9

NUM_COMPONENTS = 4
HUFFMAN_TABLES = 2  # table ids 0/1 stored; ids 2/3 rejected like the reference
DC_HUFFMAN_TABLE_VALUES_SIZE = 12
AC_HUFFMAN_TABLE_VALUES_SIZE = 162


@dataclasses.dataclass
class FrameComponent:
    """Per-component SOF fields (picture_parameter_buffer.components,
    parser.h:62-75)."""

    component_id: int = 0
    h_sampling_factor: int = 0
    v_sampling_factor: int = 0
    quantiser_table_selector: int = 0


@dataclasses.dataclass
class ScanComponent:
    """Per-component SOS fields (slice_parameter_buffer.components,
    parser.h:124-139)."""

    component_selector: int = 0
    dc_table_selector: int = 0
    ac_table_selector: int = 0


@dataclasses.dataclass
class HuffmanTableSet:
    """One table id's DC+AC code-length counts and symbol values
    (HuffmanTableBuffer layout, parser.h:104-114)."""

    num_dc_codes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(16, np.uint8))
    dc_values: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(DC_HUFFMAN_TABLE_VALUES_SIZE, np.uint8))
    num_ac_codes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(16, np.uint8))
    ac_values: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(AC_HUFFMAN_TABLE_VALUES_SIZE, np.uint8))


@dataclasses.dataclass
class JpegStreamParams:
    """Everything the decode engine needs for one image — the analog of
    ``JpegStreamParameters`` (parser.h:165-172)."""

    picture_width: int = 0
    picture_height: int = 0
    num_components: int = 0
    components: List[FrameComponent] = dataclasses.field(default_factory=list)

    # Quant tables in zigzag *file* order, one row per table id (parser.h:84-88).
    quantiser_tables: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((NUM_COMPONENTS, 64), np.uint8))
    load_quantiser_table: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_COMPONENTS, np.uint8))

    huffman_tables: List[HuffmanTableSet] = dataclasses.field(
        default_factory=lambda: [HuffmanTableSet(), HuffmanTableSet()])
    load_huffman_table: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(HUFFMAN_TABLES, np.uint8))

    scan_components: List[ScanComponent] = dataclasses.field(default_factory=list)
    restart_interval: int = 0
    num_mcus: int = 0

    # [first entropy-coded byte .. EOI) span of the input buffer.
    slice_data: bytes = b""

    chroma_subsampling: ChromaSubsampling = ChromaSubsampling.CSS_UNKNOWN

    # --- derived geometry helpers (used by entropy/pipeline stages) ---

    @property
    def max_h_sampling(self) -> int:
        return max((c.h_sampling_factor for c in self.components), default=1)

    @property
    def max_v_sampling(self) -> int:
        return max((c.v_sampling_factor for c in self.components), default=1)

    @property
    def mcus_per_row(self) -> int:
        hs = self.components[0].h_sampling_factor if self.components else 1
        return (self.picture_width + hs * 8 - 1) // (hs * 8)

    @property
    def mcu_rows(self) -> int:
        vs = self.components[0].v_sampling_factor if self.components else 1
        return (self.picture_height + vs * 8 - 1) // (vs * 8)

    def component_block_dims(self, i: int) -> tuple:
        """(blocks_h, blocks_w) of component i's MCU-aligned coefficient
        plane. Plane is padded to a whole number of MCUs, like the surfaces
        the VCN decoder writes."""
        c = self.components[i]
        return (self.mcu_rows * c.v_sampling_factor,
                self.mcus_per_row * c.h_sampling_factor)


_NATIVE_PARSER = ("unset",)


def _native_parser():
    """The native parse function, or None (cached; import cycles force the
    lazy lookup)."""
    global _NATIVE_PARSER
    if _NATIVE_PARSER == ("unset",):
        import os
        fn = None
        if os.environ.get("ROCJPEG_TPU_PARSER") != "python":
            try:
                from ..runtime import native as _n
                if getattr(_n, "PARSE_AVAILABLE", False):
                    fn = _n.parse_header
            except Exception:
                fn = None
        _NATIVE_PARSER = (fn,)
    return _NATIVE_PARSER[0]


class JpegStreamParser:
    """Stream parser session — analog of ``RocJpegStreamParser``
    (parser.h:186-269). One parser holds the params of the last parsed
    stream; reusable across images like the reference's stream handle."""

    def __init__(self) -> None:
        self._params: Optional[JpegStreamParams] = None

    @property
    def params(self) -> JpegStreamParams:
        """GetJpegStreamParameters analog (parser.h:207)."""
        if self._params is None:
            raise RocJpegError(Status.BAD_JPEG, "no stream parsed")
        return self._params

    def parse(self, data: bytes) -> JpegStreamParams:
        """ParseJpegStream analog (parser.cpp:43-124). Raises RocJpegError
        with Status.BAD_JPEG on malformed input.

        Uses the native C++ parser (csrc/ rjt_parse) when built — exact
        same fields and error strings; this Python implementation is the
        portable fallback and the oracle it is tested against. Force it
        with ROCJPEG_TPU_PARSER=python."""
        if data is None:
            raise RocJpegError(Status.INVALID_PARAMETER, "data is None")
        native = _native_parser()
        if native is not None:
            self._params = native(bytes(data))
            return self._params
        buf = bytes(data)
        n = len(buf)
        if n < 4 or buf[0] != 0xFF or buf[1] != SOI:
            raise RocJpegError(Status.BAD_JPEG, "invalid JPEG: missing SOI")

        p = JpegStreamParams()
        pos = 2
        sos_found = False
        dht_found = False
        dqt_found = False
        scan_start = 0

        try:
            pos, sos_found, dht_found, dqt_found, scan_start = (
                self._marker_loop(buf, pos, p))
        except RocJpegError:
            raise
        except (IndexError, ValueError, struct.error) as exc:
            # Truncated/garbled marker segment: surface as BAD_JPEG, never a
            # raw Python error (C API analog returns a status, api.cpp:168-174).
            raise RocJpegError(Status.BAD_JPEG, f"corrupt marker segment: {exc}")

        if not dht_found:
            raise RocJpegError(Status.BAD_JPEG, "didn't find any Huffman table")
        if not dqt_found:
            raise RocJpegError(Status.BAD_JPEG, "didn't find any quantization table")
        if not sos_found:
            raise RocJpegError(Status.BAD_JPEG, "didn't find the SOS marker")

        # ParseEOI (parser.cpp:400-416): slice data = [scan_start .. 0xFFD9),
        # or the remainder of the buffer when EOI is missing.
        eoi = buf.find(b"\xff\xd9", scan_start)
        end = eoi if eoi >= 0 else n
        p.slice_data = buf[scan_start:end]

        self._params = p
        return p

    def _marker_loop(self, buf: bytes, pos: int, p: JpegStreamParams):
        n = len(buf)
        sos_found = dht_found = dqt_found = False
        scan_start = 0
        while not sos_found and pos < n:
            # Skip 0xFF fill bytes (parser.cpp:76-77).
            while pos < n and buf[pos] == 0xFF:
                pos += 1
            if pos >= n:
                break
            marker = buf[pos]
            pos += 1
            if pos + 2 > n:
                break
            chunk_len = struct.unpack_from(">H", buf, pos)[0]
            next_chunk = pos + chunk_len

            if marker == SOF0:
                self._parse_sof(buf, pos, p)
            elif marker == DHT:
                self._parse_dht(buf, pos, p)
                dht_found = True
            elif marker == DQT:
                self._parse_dqt(buf, pos, p)
                dqt_found = True
            elif marker == DRI:
                self._parse_dri(buf, pos, p)
            elif marker == SOS:
                scan_start = self._parse_sos(buf, pos, p)
                sos_found = True
            # default: skip unknown marker by length (parser.cpp:105-106)
            pos = next_chunk
        return pos, sos_found, dht_found, dqt_found, scan_start

    # --- marker segment parsers ---

    def _parse_sof(self, buf: bytes, pos: int, p: JpegStreamParams) -> None:
        """ParseSOF analog (parser.cpp:160-207). ``pos`` points at the length
        field; frame fields start at pos+2 but the reference indexes from the
        length field (stream_[3] = height MSB), mirrored here."""
        p.picture_height = struct.unpack_from(">H", buf, pos + 3)[0]
        p.picture_width = struct.unpack_from(">H", buf, pos + 5)[0]
        p.num_components = buf[pos + 7]
        if p.num_components > NUM_COMPONENTS - 1:
            raise RocJpegError(Status.BAD_JPEG, "invalid number of JPEG components")
        q = pos + 8
        p.components = []
        for _ in range(p.num_components):
            comp = FrameComponent(
                component_id=buf[q],
                h_sampling_factor=buf[q + 1] >> 4,
                v_sampling_factor=buf[q + 1] & 0xF,
                quantiser_table_selector=buf[q + 2],
            )
            if comp.quantiser_table_selector >= NUM_COMPONENTS:
                raise RocJpegError(Status.BAD_JPEG, "invalid quantization table id")
            p.components.append(comp)
            q += 3

        # MCU count from component-0 factors (parser.cpp:197-198).
        h0 = p.components[0].h_sampling_factor
        v0 = p.components[0].v_sampling_factor
        if h0 == 0 or v0 == 0:
            raise RocJpegError(Status.BAD_JPEG, "invalid sampling factors")
        p.num_mcus = (
            ((p.picture_width + h0 * 8 - 1) // (h0 * 8))
            * ((p.picture_height + v0 * 8 - 1) // (v0 * 8))
        )

        def factor(i: int, attr: str) -> int:
            return getattr(p.components[i], attr) if i < p.num_components else 0

        p.chroma_subsampling = classify_subsampling(
            factor(0, "h_sampling_factor"), factor(1, "h_sampling_factor"),
            factor(2, "h_sampling_factor"), factor(0, "v_sampling_factor"),
            factor(1, "v_sampling_factor"), factor(2, "v_sampling_factor"),
        )

    def _parse_dqt(self, buf: bytes, pos: int, p: JpegStreamParams) -> None:
        """ParseDQT analog (parser.cpp:217-246)."""
        seg_len = struct.unpack_from(">H", buf, pos)[0]
        end = pos + seg_len
        q = pos + 2
        while q < end:
            index = buf[q]
            q += 1
            if index >> 4:
                raise RocJpegError(
                    Status.BAD_JPEG, "16-bit quantization table is not supported")
            if index >= 4:
                raise RocJpegError(Status.BAD_JPEG, "invalid quantization table id")
            p.quantiser_tables[index & 0x0F] = np.frombuffer(
                buf, np.uint8, 64, q)
            p.load_quantiser_table[index & 0x0F] = 1
            q += 64

    def _parse_dht(self, buf: bytes, pos: int, p: JpegStreamParams) -> None:
        """ParseDHT analog (parser.cpp:256-313)."""
        length = struct.unpack_from(">H", buf, pos)[0] - 2
        q = pos + 2
        while length > 0:
            index = buf[q]
            q += 1
            is_ac = bool(index & 0xF0)
            table_id = index & 0x0F
            if table_id >= HUFFMAN_TABLES:
                raise RocJpegError(Status.BAD_JPEG, "invalid Huffman table id")
            bits = np.frombuffer(buf, np.uint8, 16, q)
            count = int(bits.sum())
            q += 16
            tbl = p.huffman_tables[table_id]
            if is_ac:
                if count > AC_HUFFMAN_TABLE_VALUES_SIZE:
                    raise RocJpegError(Status.BAD_JPEG, "invalid AC Huffman table")
                tbl.num_ac_codes = bits.copy()
                tbl.ac_values[:count] = np.frombuffer(buf, np.uint8, count, q)
            else:
                if count > DC_HUFFMAN_TABLE_VALUES_SIZE:
                    raise RocJpegError(Status.BAD_JPEG, "invalid DC Huffman table")
                tbl.num_dc_codes = bits.copy()
                tbl.dc_values[:count] = np.frombuffer(buf, np.uint8, count, q)
            p.load_huffman_table[table_id] = 1
            q += count
            length -= 1 + 16 + count

    def _parse_dri(self, buf: bytes, pos: int, p: JpegStreamParams) -> None:
        """ParseDRI analog (parser.cpp:374-390)."""
        if struct.unpack_from(">H", buf, pos)[0] != 4:
            raise RocJpegError(Status.BAD_JPEG, "invalid size for DRI marker")
        p.restart_interval = struct.unpack_from(">H", buf, pos + 2)[0]

    def _parse_sos(self, buf: bytes, pos: int, p: JpegStreamParams) -> int:
        """ParseSOS analog (parser.cpp:324-363). Returns the offset of the
        first entropy-coded byte."""
        num_components = buf[pos + 2]
        if num_components > NUM_COMPONENTS - 1:
            raise RocJpegError(Status.BAD_JPEG, "invalid number of scan components")
        q = pos + 3
        p.scan_components = []
        for i in range(num_components):
            component_id = buf[q]
            table = buf[q + 1]
            q += 2
            sc = ScanComponent(
                component_selector=component_id,
                dc_table_selector=(table >> 4) & 0x0F,
                ac_table_selector=table & 0x0F,
            )
            if sc.ac_table_selector >= 4 or sc.dc_table_selector >= 4:
                raise RocJpegError(Status.BAD_JPEG, "invalid Huffman table selector")
            if (i >= len(p.components)
                    or component_id != p.components[i].component_id):
                raise RocJpegError(
                    Status.BAD_JPEG, "component id mismatch between SOS and SOF")
            p.scan_components.append(sc)
        return q + 3  # skip Ss, Se, Ah/Al


def classify_subsampling(c1h: int, c2h: int, c3h: int,
                         c1v: int, c2v: int, c3v: int) -> ChromaSubsampling:
    """GetChromaSubsampling analog — the exact sampling-factor pattern table
    from parser.cpp:432-470, including its multi-variant 444/422/400 rows."""
    f = (c1h, c2h, c3h, c1v, c2v, c3v)
    if f in ((1, 1, 1, 1, 1, 1), (2, 2, 2, 2, 2, 2), (4, 4, 4, 4, 4, 4)):
        return ChromaSubsampling.CSS_444
    if f == (1, 1, 1, 2, 1, 1):
        return ChromaSubsampling.CSS_440
    if f in ((2, 1, 1, 1, 1, 1), (2, 1, 1, 2, 2, 2), (2, 2, 2, 2, 1, 1)):
        return ChromaSubsampling.CSS_422
    if f == (2, 1, 1, 2, 1, 1):
        return ChromaSubsampling.CSS_420
    if f == (4, 1, 1, 1, 1, 1):
        return ChromaSubsampling.CSS_411
    if c2h == 0 and c3h == 0 and c2v == 0 and c3v == 0 and c1h > 0 and c1v > 0:
        # Single-component streams are 4:0:0 for any luma sampling factor.
        # Superset of the reference table, which lists only the 1x1 and 4x4
        # variants (parser.cpp:462-466) and mislabels e.g. 2x2 grayscale —
        # as written by libjpeg when asked for subsampled grayscale — as
        # UNKNOWN. Strictly more JPEGs decode; none decode differently.
        return ChromaSubsampling.CSS_400
    return ChromaSubsampling.CSS_UNKNOWN
