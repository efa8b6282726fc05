"""Dequantization + 8x8 inverse DCT, exact fixed-point (int32).

The reference performs IDCT inside the VCN ASIC (never in software; see
SURVEY.md §0). This framework implements it as a vectorized fixed-point
Loeffler-Lightenberg-Moshovitz 8-point IDCT with the standard 13-bit scaled
constants — the same arithmetic contract as libjpeg's "islow" path, so
decoded luma is bit-identical to the CPU JPEG ecosystem, and, because every
operation is int32 add/mul/shift, results are bit-identical across numpy,
XLA:CPU, and XLA:GPU.

The function is written against an array-namespace parameter ``xp`` (numpy
or jax.numpy): the golden CPU oracle and the device pipeline execute the very
same expression graph, making the bit-exactness tests meaningful rather than
circular at the algorithm level (independent validation against PIL/libjpeg
lives in tests/test_golden.py).

Layout contract: blocks are (..., 8, 8) int32/int16 natural-order coefficient
matrices (row-major frequency order); output is (..., 8, 8) uint8 samples.
All elementwise integer work, which XLA fuses on any backend.
"""

from __future__ import annotations

CONST_BITS = 13
PASS1_BITS = 2

# round(c * 2**13) for the Loeffler rotation constants.
FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172


def _descale(x, n: int):
    """Round-to-nearest right shift: (x + 2^(n-1)) >> n, arithmetic."""
    return (x + (1 << (n - 1))) >> n


def _idct8(inp, first_pass: bool):
    """One 8-point 1-D IDCT stage over axis -2 (the 8 frequency rows of each
    block), vectorized over every other axis.

    ``inp`` is a list of eight int32 arrays (frequency indices 0..7).
    Returns a list of eight spatial-sample arrays. Pass 1 descales by
    CONST_BITS-PASS1_BITS; pass 2 by CONST_BITS+PASS1_BITS+3 (final level).
    """
    # Even part.
    z2, z3 = inp[2], inp[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * (-FIX_1_847759065)
    tmp3 = z1 + z2 * FIX_0_765366865
    z2, z3 = inp[0], inp[4]
    tmp0 = (z2 + z3) << CONST_BITS
    tmp1 = (z2 - z3) << CONST_BITS
    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    # Odd part.
    t0, t1, t2, t3 = inp[7], inp[5], inp[3], inp[1]
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    shift = (CONST_BITS - PASS1_BITS) if first_pass else (CONST_BITS + PASS1_BITS + 3)
    return [
        _descale(tmp10 + t3, shift),
        _descale(tmp11 + t2, shift),
        _descale(tmp12 + t1, shift),
        _descale(tmp13 + t0, shift),
        _descale(tmp13 - t0, shift),
        _descale(tmp12 - t1, shift),
        _descale(tmp11 - t2, shift),
        _descale(tmp10 - t3, shift),
    ]


def dequant_idct_8x8(xp, coeffs, quant):
    """Dequantize + 2-D IDCT + level shift + clamp.

    Args:
      xp: array namespace (numpy or jax.numpy).
      coeffs: (..., 8, 8) integer natural-order coefficients.
      quant:  broadcastable (..., 8, 8) natural-order quant table (uint16/int).

    Returns (..., 8, 8) uint8 spatial samples.
    """
    x = coeffs.astype(xp.int32) * quant.astype(xp.int32)

    # Pass 1: columns (operate along axis -2).
    cols = [x[..., i, :] for i in range(8)]
    cols = _idct8(cols, first_pass=True)
    # Pass 2: rows. After pass 1 the block is transposed in effect: stack the
    # column results as rows and split along the last axis.
    y = xp.stack(cols, axis=-2)  # (..., 8 spatial rows?, 8 cols) — see note
    rows = [y[..., :, i] for i in range(8)]
    rows = _idct8(rows, first_pass=False)
    out = xp.stack(rows, axis=-1)  # (..., 8, 8)

    out = xp.clip(out + 128, 0, 255).astype(xp.uint8)
    return out
