"""Plane assembly, chroma upsampling, and native surface layouts.

Re-expresses the reference's surface formats and the 13 HIP layout/convert
kernels (src/rocjpeg_hip_kernels.h:44-302) as array transforms:

- NATIVE layouts per subsampling (api/rocjpeg.h:125-130,
  surface-format switch at src/rocjpeg_vaapi_decoder.cpp:594-638):
  444→three planes (444P), 440→three planes half-height chroma (422V),
  422→packed YUYV, 420→Y + interleaved UV (NV12), 400→Y (Y800).
- Chroma upsampling is nearest-neighbor, exactly like the HIP RGB kernels:
  NV12 duplicates U/V across each 2x2 (hip_kernels.cpp:1401-1429), 440
  shares a chroma row between 2 luma rows (hip_kernels.cpp:496-505), YUYV
  shares U/V between 2 horizontal pixels.

All functions take an array-namespace ``xp`` (numpy | jax.numpy) so the CPU
golden decoder and the device pipeline share one definition.
"""

from __future__ import annotations


def blocks_to_plane(xp, blocks):
    """(..., bh, bw, 8, 8) spatial blocks → (..., bh*8, bw*8) plane."""
    s = blocks.shape
    bh, bw = s[-4], s[-3]
    nd = blocks.ndim
    perm = tuple(range(nd - 4)) + (nd - 4, nd - 2, nd - 3, nd - 1)
    return xp.transpose(blocks, perm).reshape(s[:-4] + (bh * 8, bw * 8))


def upsample_h2(xp, plane):
    """Horizontal nearest 2x (422/420 chroma → full width)."""
    return xp.repeat(plane, 2, axis=-1)


def upsample_v2(xp, plane):
    """Vertical nearest 2x (440/420 chroma → full height)."""
    return xp.repeat(plane, 2, axis=-2)


def upsample_to_luma(xp, plane, h_factor: int, v_factor: int):
    """Nearest-neighbor upsample by integer factors (handles 411's 4x too)."""
    out = plane
    if v_factor > 1:
        out = xp.repeat(out, v_factor, axis=-2)
    if h_factor > 1:
        out = xp.repeat(out, h_factor, axis=-1)
    return out


def pack_yuyv(xp, y, u, v):
    """(H, W) luma + (H, W/2) chroma → (H, 2W) packed YUYV (Y0 U0 Y1 V0).

    Native layout for 4:2:2 (ROCJPEG_FOURCC_YUYV,
    src/rocjpeg_vaapi_decoder.h:52)."""
    h, w = y.shape[-2], y.shape[-1]
    pairs = w // 2
    y_pairs = y.reshape(y.shape[:-1] + (pairs, 2))
    quad = xp.stack(
        [y_pairs[..., 0], u[..., :pairs], y_pairs[..., 1], v[..., :pairs]],
        axis=-1,
    )
    return quad.reshape(y.shape[:-2] + (h, w * 2))


def unpack_yuyv(xp, yuyv):
    """(H, 2W) YUYV → (y (H,W), u (H,W/2), v (H,W/2)).

    Analog of ConvertPackedYUYVToPlanarYUV (hip_kernels.cpp:2233)."""
    h = yuyv.shape[-2]
    w2 = yuyv.shape[-1]
    quad = yuyv.reshape(yuyv.shape[:-1] + (w2 // 4, 4))
    y = xp.stack([quad[..., 0], quad[..., 2]], axis=-1)
    y = y.reshape(yuyv.shape[:-2] + (h, w2 // 2))
    return y, quad[..., 1], quad[..., 3]


def interleave_uv(xp, u, v):
    """(H, W) U + V → (H, 2W) interleaved UV (NV12 second plane)."""
    h, w = u.shape[-2], u.shape[-1]
    return xp.stack([u, v], axis=-1).reshape(u.shape[:-2] + (h, 2 * w))


def deinterleave_uv(xp, uv):
    """NV12 UV plane (H, 2W) → (u, v) each (H, W).

    Analog of ConvertInterleavedUVToPlanarUV (hip_kernels.cpp:2123)."""
    h = uv.shape[-2]
    w = uv.shape[-1] // 2
    pairs = uv.reshape(uv.shape[:-1] + (w, 2))
    return pairs[..., 0], pairs[..., 1]


def interleave_rgb(xp, r, g, b):
    """Three (H, W) planes → (H, 3W) packed interleaved RGB bytes
    (ROCJPEG_OUTPUT_RGB channel-0 layout)."""
    h, w = r.shape[-2], r.shape[-1]
    return xp.stack([r, g, b], axis=-1).reshape(r.shape[:-2] + (h, 3 * w))
