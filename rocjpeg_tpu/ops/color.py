"""YUV → RGB color conversion, full-range BT.709, exact fixed-point.

The reference converts with fp32 FMAs and packs via the AMD
``v_cvt_pk_u8_f32`` instruction (src/rocjpeg_hip_kernels.cpp:25-30, constants
at :76-78):

    R = Y + 1.5748*(V-128)
    G = Y - 0.1873*(U-128) - 0.4681*(V-128)
    B = Y + 1.8556*(U-128)

This framework uses 16-bit fixed-point int32 arithmetic with round-half-up,
which (a) is bit-identical across numpy / XLA:CPU / XLA:GPU — float FMA
fusion is compiler-dependent, so a float path could not promise cross-
platform exactness — and (b) matches the reference's real-valued formula
within 1 LSB, quantified EXHAUSTIVELY (tests/test_color_exhaustive.py):
R and B match the round-half-up real-valued formula on all 65,536 (Y,C)
combos each; G deviates by exactly 1 LSB on 6,084 of 16,777,216 (Y,U,V)
combos (0.036%) that sit at quantization/tie points of the two 16-bit
constants. Greyscale (4:0:0) replicates Y into all three channels, like
ColorConvertYUV400ToRGBKernel (hip_kernels.cpp:1915-1927).
"""

from __future__ import annotations

FIX_BITS = 16
FIX_ROUND = 1 << (FIX_BITS - 1)

CR_V = round(1.5748 * (1 << FIX_BITS))  # 103206
CG_U = round(-0.1873 * (1 << FIX_BITS))  # -12276
CG_V = round(-0.4681 * (1 << FIX_BITS))  # -30677
CB_U = round(1.8556 * (1 << FIX_BITS))  # 121618


def yuv_to_rgb(xp, y, u, v):
    """Convert full-resolution Y/U/V uint8 planes to (R, G, B) uint8 planes.

    All three inputs must already be at luma resolution (chroma upsampling
    happens in ops/upsample.py, nearest-neighbor like the reference's HIP
    kernels).
    """
    yi = y.astype(xp.int32) << FIX_BITS
    ui = u.astype(xp.int32) - 128
    vi = v.astype(xp.int32) - 128
    r = (yi + CR_V * vi + FIX_ROUND) >> FIX_BITS
    g = (yi + CG_U * ui + CG_V * vi + FIX_ROUND) >> FIX_BITS
    b = (yi + CB_U * ui + FIX_ROUND) >> FIX_BITS
    clip = lambda t: xp.clip(t, 0, 255).astype(xp.uint8)
    return clip(r), clip(g), clip(b)
