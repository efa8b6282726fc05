"""CPU golden decoder: the trusted end-to-end numpy reference path.

Composes parser → entropy decode → dequant+IDCT → postprocess entirely in
numpy. This is the correctness oracle the reference never had (its CI says
"Unit tests - TBD", .jenkins/common.groovy:60): the device pipeline must match
it bit-for-bit, and it is itself validated against PIL/libjpeg in
tests/test_golden.py (luma bit-exact on every corpus image — both implement
the standard fixed-point islow IDCT contract).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..ops import idct as idct_ops
from ..ops import postprocess
from ..status import RocJpegError, Status
from ..types import ChromaSubsampling, CropRectangle, OutputFormat
from . import entropy
from .bitstream import JpegStreamParams, JpegStreamParser
from .zigzag import dezigzag


def decode_planes(params: JpegStreamParams) -> Tuple[np.ndarray, ...]:
    """Entropy decode + dequant + IDCT → MCU-padded uint8 sample planes
    (y, u, v); u/v are None for single-component streams."""
    return planes_from_coefficients(params, entropy.decode_scan(params))


def planes_from_coefficients(params: JpegStreamParams,
                             coeff_planes) -> Tuple[np.ndarray, ...]:
    """Dequant + IDCT of per-component natural-order coefficient planes
    (as ``entropy.decode_scan`` or the native ``decode_scan`` return them)
    → MCU-padded uint8 sample planes (y, u, v)."""
    out = []
    for ci, coeffs in enumerate(coeff_planes):
        qid = params.components[ci].quantiser_table_selector
        if not params.load_quantiser_table[qid]:
            raise RocJpegError(Status.BAD_JPEG, f"quant table {qid} not loaded")
        qtab = dezigzag(params.quantiser_tables[qid].astype(np.int32))
        blocks = coeffs.reshape(coeffs.shape[:-1] + (8, 8))
        samples = idct_ops.dequant_idct_8x8(np, blocks, qtab.reshape(8, 8))
        out.append(postprocess.layout.blocks_to_plane(np, samples))
    while len(out) < 3:
        out.append(None)
    return tuple(out[:3])


def decode(data: bytes,
           output_format: OutputFormat = OutputFormat.NATIVE,
           crop: Optional[CropRectangle] = None) -> List[Tuple[np.ndarray, int]]:
    """Full golden decode of one JPEG byte stream. Returns the channel list
    [(array, pitch), ...] in the requested output format."""
    parser = JpegStreamParser()
    params = parser.parse(data)
    planes = decode_planes(params)
    return postprocess.render_output(
        np, params.chroma_subsampling, planes,
        params.picture_width, params.picture_height, output_format, crop)
