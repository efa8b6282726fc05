"""JPEG zigzag scan order constants.

``ZIGZAG_ORDER[k]`` = natural (row-major) index of the k-th coefficient in
zigzag scan order. ``NATURAL_TO_ZIGZAG`` is the inverse permutation.

The reference never dezigzags on the CPU — it forwards file-order quant
tables to the VCN ASIC (src/rocjpeg_parser.cpp:217-246). In this framework
the host entropy decoder scatters coefficients straight into natural order
(one LUT lookup at write time) so the device dequant+IDCT stage sees dense
natural-order 8x8 blocks and needs no gather.
"""

import numpy as np

ZIGZAG_ORDER = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10,
        17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

NATURAL_TO_ZIGZAG = np.argsort(ZIGZAG_ORDER).astype(np.int32)


def dezigzag(table_zz: np.ndarray) -> np.ndarray:
    """Convert a 64-entry array (or trailing-axis-64 array) from zigzag file
    order to natural row-major order."""
    out = np.empty_like(table_zz)
    out[..., ZIGZAG_ORDER] = table_zz
    return out
