"""Jitted device decode pipeline: coefficient planes → output-format arrays.

This is the device-side half of the framework — the replacement
for everything the reference runs on the VCN ASIC plus its HIP post-process
kernels (src/rocjpeg_hip_kernels.cpp): dequantization, 8x8 IDCT, chroma
upsampling, color conversion, and output-format layout, fused into one XLA
program per static configuration.

Shape policy (the XLA analog of the reference's JpegStreamKey grouping,
src/rocjpeg_vaapi_decoder.h:223-265): one compiled executable per
(subsampling, padded-plane-geometry, output format, crop, batch-bucket).
Batches are padded to power-of-two buckets so the jit cache stays small
while arbitrary batch sizes run without recompiling.

All math is int32/uint8 elementwise, which XLA fuses for any backend.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .core.bitstream import JpegStreamParams
from .core.zigzag import dezigzag
from .ops import idct as idct_ops
from .ops import layout, postprocess
from .status import RocJpegError, Status
from .types import (ChromaSubsampling, CropRectangle, LazyChannel,
                    OutputFormat)

CSS = ChromaSubsampling

_tls = threading.local()


def last_entropy_path() -> str:
    """Entropy path taken by the calling thread's most recent
    :func:`decode_group_device_entropy` call: ``'wave'`` (real restart
    lanes) or ``'wave-virtual'`` (host index walk + virtual restarts).
    Benches and tools report this so path selection is visible in every
    recorded number."""
    return getattr(_tls, "path", "?")


def _plane_from_coeffs(coeffs, quant):
    """(B, bh, bw, 64) int16 coeffs + (B, 64) quant → (B, bh*8, bw*8) uint8."""
    b = coeffs.shape[0]
    blocks = coeffs.reshape(coeffs.shape[:-1] + (8, 8))
    q = quant.reshape(b, 1, 1, 8, 8)
    samples = idct_ops.dequant_idct_8x8(jnp, blocks, q)
    return layout.blocks_to_plane(jnp, samples)


def build_decode_fn(css: ChromaSubsampling, width: int, height: int,
                    chroma_present: bool,
                    output_format: OutputFormat,
                    crop: Optional[tuple]) -> callable:
    """The raw (un-jitted) decode program for one static config:
    fn(y_coeffs, u_coeffs, v_coeffs, qy, qu, qv) -> tuple of channel arrays
    (leading batch axis). Chroma args are ignored for 4:0:0.

    Exposed so the dist layer can re-jit it with mesh shardings."""
    crop_rect = CropRectangle(*crop) if crop is not None else None

    def fn(y_coeffs, u_coeffs, v_coeffs, qy, qu, qv):
        y = _plane_from_coeffs(y_coeffs, qy)
        if css == CSS.CSS_400 or not chroma_present:
            planes = (y, None, None)
        else:
            u = _plane_from_coeffs(u_coeffs, qu)
            v = _plane_from_coeffs(v_coeffs, qv)
            planes = (y, u, v)
        chans = postprocess.render_output(
            jnp, css, planes, width, height, output_format, crop_rect)
        return tuple(arr for arr, _pitch in chans)

    return fn


@functools.lru_cache(maxsize=256)
def compiled_decode(css: ChromaSubsampling, width: int, height: int,
                    luma_blocks: Tuple[int, int],
                    chroma_blocks: Optional[Tuple[int, int]],
                    output_format: OutputFormat,
                    crop: Optional[tuple]) -> callable:
    """Jitted + cached single-device variant of :func:`build_decode_fn`."""
    return jax.jit(build_decode_fn(css, width, height,
                                   chroma_blocks is not None,
                                   output_format, crop))


def output_pitches(css: ChromaSubsampling, width: int, height: int,
                   output_format: OutputFormat,
                   crop: Optional[CropRectangle]) -> list:
    """Pitches for each returned channel (static metadata, computed on host)."""
    eff_w, eff_h, _, _ = postprocess.resolve_roi(width, height, crop)
    fmt = OutputFormat(output_format)
    if css == CSS.CSS_400:
        if fmt == OutputFormat.RGB:
            return [3 * eff_w]
        if fmt == OutputFormat.RGB_PLANAR:
            return [eff_w] * 3
        return [eff_w]
    hf, vf = postprocess.CHROMA_FACTORS[css]
    if fmt == OutputFormat.NATIVE:
        if css == CSS.CSS_422:
            return [2 * eff_w]
        if css == CSS.CSS_420:
            return [eff_w, eff_w]
        return [eff_w] * 3
    if fmt == OutputFormat.YUV_PLANAR:
        return [eff_w, eff_w // hf, eff_w // hf]
    if fmt == OutputFormat.Y:
        return [eff_w]
    if fmt == OutputFormat.RGB:
        return [3 * eff_w]
    if fmt == OutputFormat.RGB_PLANAR:
        return [eff_w] * 3
    raise RocJpegError(Status.INVALID_PARAMETER, f"bad format {output_format}")


def bucket_batch(n: int) -> int:
    """Round batch size up to a power-of-two bucket (min 1) to bound the
    compile cache — the static-shape analog of the reference's per-group
    vaCreateSurfaces (vaapi_decoder.cpp:774-834)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def stack_group_inputs(params_list, coeff_planes_list, pad_to: int):
    """Stack per-image host coefficient planes + quant tables for one shape
    group into batch arrays, padding the batch axis to ``pad_to`` by
    repeating the first image (results for pad rows are discarded)."""
    n = len(params_list)
    ncomp = params_list[0].num_components

    def stacked(ci):
        arrs = [cp[ci] for cp in coeff_planes_list]
        arrs += [arrs[0]] * (pad_to - n)
        return np.stack(arrs)

    y = stacked(0)
    qy, qu, qv = quant_rows(params_list, pad_to)
    if ncomp >= 3:
        return y, stacked(1), stacked(2), qy, qu, qv
    z = np.zeros((pad_to, 1, 1, 64), np.int16)
    return y, z, z, qy, qu, qv


def quant_rows(params_list, pad_to: int):
    """Per-image dezigzagged quant tables, (pad_to, 64) int32 each for Y, U
    and V; absent components get ones, pad rows repeat the first image."""
    rows = ([], [], [])
    for p in params_list:
        for ci in range(3):
            if ci < p.num_components:
                qid = p.components[ci].quantiser_table_selector
                rows[ci].append(dezigzag(
                    p.quantiser_tables[qid].astype(np.int32)))
            else:
                rows[ci].append(np.ones(64, np.int32))
    return tuple(np.stack(r + [r[0]] * (pad_to - len(params_list)))
                 for r in rows)


@functools.lru_cache(maxsize=64)
def _mcu_maps(geom):
    """Per-component (bh, bw) int32 maps: block -> MCU index within the
    image, for the DC fixup of virtual-restart decodes. Static per
    geometry; folded into the jit program as constants."""
    maps = []
    mcus_w = geom.mcus_w
    ncomps = len(geom.comp_base)
    for c in range(ncomps):
        s = next(s for s in range(len(geom.comp_of_slot))
                 if geom.comp_of_slot[s] == c)
        bw = geom.blocks_w[c]
        hs = geom.col_step[s]
        vs = geom.row_step[s] // bw
        nxt = (geom.comp_base[c + 1] if c + 1 < ncomps
               else geom.total_blocks)
        bh = (nxt - geom.comp_base[c]) // bw
        by = np.arange(bh, dtype=np.int64)[:, None]
        bx = np.arange(bw, dtype=np.int64)[None, :]
        mcu = (by // vs) * mcus_w + (bx // hs)
        maps.append(mcu.astype(np.int32))
    return tuple(maps)


@functools.lru_cache(maxsize=128)
def _transform_from_flat(geom, css: ChromaSubsampling, width: int,
                         height: int, output_format: OutputFormat, crop_key,
                         dc_fix: bool = False):
    """Jitted transform program taking the wave decoder's FLAT coefficient
    tensor directly: the per-component unflatten (reshape + slice per
    component, ~8 separate device dispatches when done eagerly) happens
    inside the program. The wave stays a separate program.

    dc_fix: when True (virtual-restart decode), the program takes extra
    operands dc_flat (n_lanes, 3) int32 and lane_of_mcu (B, total_mcus)
    int32, and adds each lane's entry DC predictor to the DC coefficient of
    every block that lane decoded, before dequantization."""
    from .ops import device_entropy as de

    chroma_present = len(geom.comp_base) >= 3
    decode_fn = build_decode_fn(css, width, height, chroma_present,
                                output_format, crop_key)
    mcu_maps = _mcu_maps(geom) if dc_fix else None

    def f(coeffs_flat, qy, qu, qv, dc_flat=None, lane_of_mcu=None):
        comps = list(de.unflatten_coefficients(coeffs_flat, geom, None))
        if mcu_maps is not None:
            for ci in range(len(comps)):
                lanes = jnp.take(lane_of_mcu, mcu_maps[ci],
                                 axis=1)                  # (B, bh, bw)
                fix = jnp.take(dc_flat[:, ci], lanes)     # (B, bh, bw)
                comps[ci] = comps[ci].at[..., 0].add(fix.astype(jnp.int16))
        y = comps[0]
        if len(comps) >= 3:
            u, v = comps[1], comps[2]
        else:
            u = v = jnp.zeros((geom.batch, 1, 1, 64), jnp.int16)
        return decode_fn(y, u, v, qy, qu, qv)

    return jax.jit(f)


def _roi_mcu_range(p0, crop: Optional[CropRectangle]):
    """MCU index range [lo, hi) covering the crop's MCU rows, or None when
    the crop is absent / spans all rows. Only whole MCU-row bands can be
    skipped — restart segments run in scan order, so columns cannot be
    restricted — which mirrors the reference's hardware ROI granularity
    (vaapi_decoder.cpp:640-658 crops in-engine; here the analog is packing
    only the ROI-intersecting segments)."""
    if crop is None:
        return None
    interleaved = len(p0.scan_components) > 1
    if interleaved:
        mcu_h = 8 * max(c.v_sampling_factor for c in p0.components)
        mcus_w = p0.mcus_per_row
        total = p0.num_mcus
    else:
        mcu_h = 8
        mcus_w = (p0.picture_width + 7) // 8
        total = mcus_w * ((p0.picture_height + 7) // 8)
    rows = -(-total // mcus_w)
    r0 = max(0, min(crop.top // mcu_h, rows))
    r1 = max(r0, min(rows, -(-crop.bottom // mcu_h)))
    if r0 == 0 and r1 >= rows:
        return None
    return (r0 * mcus_w, r1 * mcus_w)


def decode_group_device_entropy(params_list, output_format: OutputFormat,
                                crop: Optional[CropRectangle] = None,
                                virtual_k: Optional[int] = None):
    """Fully on-device decode of one same-shape group: the compressed
    bitstream (not coefficient planes) crosses the host->device link as a
    dense word stream, the wave entropy decoder expands it on the device,
    and the fused dequant/IDCT/layout epilogue consumes the coefficients in
    place: two device programs, wave then transform.

    No host<->device syncs happen here: the per-group error flags are
    returned as a device array alongside the per-image channels, and the
    caller decides when (or whether) to materialize them.

    Per-image Huffman tables ride as table banks (at most 4 sets per
    group; more raise JPEG_NOT_SUPPORTED).

    virtual_k: when set (a minimum symbol count per lane), the group's
    scans carry no restart markers and are lane-split at manufactured
    ("virtual") restart points — the host index pass records bit offsets +
    MCU indices + DC predictors at symbol-balanced MCU boundaries, and the
    transform adds each lane's entry predictor back to its DC coefficients
    (see ops/device_entropy.pack_virtual_segments). May raise
    RocJpegError(BAD_JPEG) from the index walk; callers fall back to the
    host path."""
    from .ops import device_entropy as de

    p0 = params_list[0]
    css = p0.chroma_subsampling
    n = len(params_list)
    # Batch bucketing: the wave program is keyed on the batch via out_size,
    # so pad to power-of-two buckets (pad images contribute zero lanes; their
    # coefficient slots decode to zero and are sliced away below).
    batch = bucket_batch(n)
    # Per-image Huffman tables ride as BANKS (lanes carry a bank index);
    # groups therefore key on shape alone. >4 distinct table sets raises
    # JPEG_NOT_SUPPORTED and the caller falls back to the host path.
    tables, bank_of = de.DeviceScanTables.from_params_banked(params_list)
    total_blocks = de.GroupGeometry.from_params(p0, batch).total_blocks
    dc_flat = lane_of_mcu = None
    mcu_range = _roi_mcu_range(p0, crop)
    _tls.path = "wave"
    if virtual_k:
        _tls.path = "wave-virtual"
        packed, dc_flat, lane_of_mcu = de.pack_virtual_segments(
            params_list, total_blocks, virtual_k, mcu_range=mcu_range,
            bank_of=bank_of)
        if batch > n:  # pad images contribute no lanes / zero predictors
            lane_of_mcu = np.concatenate(
                [lane_of_mcu,
                 np.zeros((batch - n, lane_of_mcu.shape[1]), np.int32)])
    else:
        packed = de.pack_segments(params_list, total_blocks,
                                  mcu_range=mcu_range, bank_of=bank_of)
    qy, qu, qv = quant_rows(params_list, batch)

    # Bundle EVERY per-call array — including the dense word stream — into
    # ONE host->device transfer (see de.stage_small_args).
    to_stage = [("mcu_start", packed.mcu_start),
                ("mcu_count", packed.mcu_count),
                ("img_base", packed.img_base),
                ("lentab", tables.lentab), ("values", tables.values),
                ("qy", qy), ("qu", qu), ("qv", qv),
                ("word_off", packed.word_off), ("dense", packed.dense)]
    if getattr(tables, "n_banks", 1) > 1:
        to_stage.append(("lane_bank", packed.lane_bank))
    if dc_flat is not None:
        to_stage += [("dc_flat", dc_flat), ("lane_of_mcu", lane_of_mcu)]
    staged = de.stage_small_args(to_stage)

    coeffs_flat, err, geom = de.decode_coefficients_on_device(
        params_list, tables, packed, batch=batch, dev=staged)
    lane_img = (packed.img_base // max(total_blocks, 1)).astype(np.int32)

    crop_key = (crop.left, crop.top, crop.right, crop.bottom) if crop else None
    fn = _transform_from_flat(geom, css, p0.picture_width, p0.picture_height,
                              OutputFormat(output_format), crop_key,
                              dc_flat is not None)
    if dc_flat is not None:
        outs = fn(coeffs_flat, staged["qy"], staged["qu"], staged["qv"],
                  staged["dc_flat"], staged["lane_of_mcu"])
    else:
        outs = fn(coeffs_flat, staged["qy"], staged["qu"], staged["qv"])
    pitches = output_pitches(css, p0.picture_width, p0.picture_height,
                             output_format, crop)
    per_image = []
    for i in range(n):
        per_image.append([(LazyChannel(arr, i), pitch)
                          for arr, pitch in zip(outs, pitches)])
    # lane -> group-local image index (host metadata): lets the caller map
    # errored wave lanes back to the offending stream, the analog of the
    # reference's naturally-attributing per-image loop (decoder.cpp:220-286).
    return per_image, err, lane_img


def decode_group(params_list, coeff_planes_list,
                 output_format: OutputFormat,
                 crop: Optional[CropRectangle] = None):
    """Decode one same-shape group on device. Returns per-image lists of
    (array, pitch) channels (device arrays, batch axis stripped)."""
    p0 = params_list[0]
    css = p0.chroma_subsampling
    n = len(params_list)
    pad_to = bucket_batch(n)

    y, u, v, qy, qu, qv = stack_group_inputs(params_list, coeff_planes_list, pad_to)
    luma_blocks = p0.component_block_dims(0)
    chroma_blocks = p0.component_block_dims(1) if p0.num_components >= 3 else None
    crop_key = (crop.left, crop.top, crop.right, crop.bottom) if crop else None

    fn = compiled_decode(css, p0.picture_width, p0.picture_height,
                         luma_blocks, chroma_blocks, OutputFormat(output_format),
                         crop_key)
    outs = fn(y, u, v, qy, qu, qv)
    pitches = output_pitches(css, p0.picture_width, p0.picture_height,
                             output_format, crop)
    per_image = []
    for i in range(n):
        per_image.append([(LazyChannel(arr, i), pitch)
                          for arr, pitch in zip(outs, pitches)])
    return per_image
