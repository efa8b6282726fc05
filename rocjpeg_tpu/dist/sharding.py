"""Sharded batched decode over a device mesh.

The replacement for the reference's multi-device story (one DRM render
node per handle, src/rocjpeg_vaapi_decoder.cpp:365-422): a batch of images
is sharded over the ``data`` mesh axis and, optionally, each image's block
rows over ``space``; one XLA program decodes the whole batch with every
device working in parallel. The wave needs no collectives (segments and
images are independent); XLA inserts any resharding the transform needs.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.bitstream import JpegStreamParams
from ..pipeline import (bucket_batch, output_pitches, quant_rows,
                        stack_group_inputs)
from ..runtime import host_decode
from ..status import RocJpegError, Status
from ..types import (ChromaSubsampling, CropRectangle, DecodedImage,
                     DecodeParams, OutputFormat)
from . import mesh as mesh_lib

CSS = ChromaSubsampling


@functools.lru_cache(maxsize=128)
def _sharded_decode(mesh: Mesh, css: CSS, width: int, height: int,
                    luma_blocks: tuple, chroma_blocks: Optional[tuple],
                    output_format: OutputFormat, crop: Optional[tuple]):
    """Jit the decode program with batch ('data') and block-row ('space')
    shardings baked in."""
    from ..pipeline import build_decode_fn
    base = build_decode_fn(css, width, height, chroma_blocks is not None,
                           output_format, crop)
    space = mesh.shape["space"]

    def coeff_spec(blocks):
        # Shard block rows over 'space' only when evenly divisible; chroma
        # planes of small images fall back to batch-only sharding.
        if blocks is not None and blocks[0] % space == 0:
            return NamedSharding(mesh, P("data", "space"))
        return NamedSharding(mesh, P("data"))

    y_sh = coeff_spec(luma_blocks)
    c_sh = coeff_spec(chroma_blocks)
    q_sh = NamedSharding(mesh, P("data"))
    out_sh = NamedSharding(mesh, P("data"))
    return jax.jit(
        base,
        in_shardings=(y_sh, c_sh, c_sh, q_sh, q_sh, q_sh),
        out_shardings=out_sh,
    )


@functools.lru_cache(maxsize=64)
def _sharded_wave_decode(mesh: Mesh, geom, n_lanes: int, n_words: int,
                         max_steps: int, css: CSS, width: int, height: int,
                         output_format: OutputFormat, crop: Optional[tuple]):
    """The fully on-device distributed decode: shard_map over the 'data'
    axis where each shard runs the platform's wave
    (``device_entropy.build_wave``) on its images' restart segments and the
    fused transform on its coefficient shard. No collectives are needed —
    segments and images are independent — so scaling is purely the input
    pipeline (SURVEY.md §2.4).

    ``geom`` is the SHARD-LOCAL GroupGeometry (batch = images per shard);
    n_lanes is the shard-local lane count. Each shard reads its own slice
    of the dense word stream (see :func:`_pack_mesh_lanes`)."""
    from ..ops import device_entropy as de
    from ..pipeline import build_decode_fn

    wave = de.build_wave(geom, n_lanes, n_words, max_steps)
    decode = build_decode_fn(css, width, height, geom.ncomp >= 3,
                             output_format, crop)

    def shard_fn(dense, word_off, img_base, mcu_start, mcu_count, lentab,
                 values, qy, qu, qv):
        coeffs, err = wave(dense, word_off, img_base, mcu_start, mcu_count,
                           lentab, values)
        comps = list(de.unflatten_coefficients(coeffs, geom, None))
        while len(comps) < 3:
            comps.append(jnp.zeros((geom.batch, 1, 1, 64), jnp.int16))
        outs = decode(comps[0], comps[1], comps[2], qy, qu, qv)
        return outs + (err,)

    data = P("data")
    # The wave's while_loop carry starts from freshly-created (hence
    # replicated) zeros but becomes data-varying inside the loop; the VMA
    # checker rejects that even though the computation is purely
    # per-shard, so disable it.
    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(data, data, data, data, data, P(), P(), data, data, data),
        out_specs=data, check_vma=False)
    return jax.jit(fn)


def _pack_mesh_lanes(padded, n_dev: int, per_dev: int, geom_local):
    """Pack a padded batch for the 'data'-sharded wave: device d decodes
    images [d*per_dev, (d+1)*per_dev) from its own equal-length slice of
    one dense word stream. Every device gets lanes_per_image * per_dev
    lanes with shard-local word offsets and image bases.

    Returns (dense (n_dev*W,) u32, {lane array name: (n_dev*L,) i32},
    n_words, max_steps)."""
    from ..ops import device_entropy as de

    geo = de._geometry_rows(padded, 0)
    lanes_per_image = de._bucket(max(g[0] for g in geo), de.lane_quantum())
    packs = [de.pack_segments(padded[d * per_dev:(d + 1) * per_dev],
                              geom_local.total_blocks,
                              lanes_per_image=lanes_per_image)
             for d in range(n_dev)]
    n_words = max(p.n_words for p in packs)
    width = max(max(len(p.dense), int(p.word_off.max()) + n_words)
                for p in packs)
    dense = np.zeros(n_dev * width, np.uint32)
    for d, p in enumerate(packs):
        dense[d * width:d * width + len(p.dense)] = p.dense
    lanes = {name: np.concatenate([getattr(p, name) for p in packs])
             for name in ("word_off", "img_base", "mcu_start", "mcu_count")}
    max_steps = max(de.max_steps_bound(geom_local, p) for p in packs)
    return dense, lanes, n_words, max_steps


class MeshDecoder:
    """Batch decoder sharding work across every device of a mesh.

    API-compatible with :class:`rocjpeg_tpu.api.Decoder` for
    ``decode_batched`` / ``decode`` / ``get_image_info``.

    device_entropy='auto' runs the full pipeline (wave entropy decode +
    transform) on-device per shard whenever the group's images share
    Huffman tables and restart geometry; 'off' uses the host entropy
    front-end with the sharded transform only.
    """

    def __init__(self, mesh: Optional[Mesh] = None, space: int = 1,
                 device_entropy: str = "auto"):
        self.mesh = mesh or mesh_lib.make_mesh(space=space)
        from ..api import Decoder  # host-side helpers (validation, info)
        self._host = Decoder.__new__(Decoder)
        from ..types import spec_for_device
        self._host._spec = spec_for_device(self.mesh.devices.flat[0])
        self._host._device = None
        self.spec = self._host._spec
        self._device_entropy = device_entropy

    def get_image_info(self, stream):
        return self._host.get_image_info(stream)

    def decode(self, stream, params: Optional[DecodeParams] = None):
        return self.decode_batched([stream], params)[0]

    def decode_batched(self, streams: Sequence, params=None) -> List[DecodedImage]:
        if streams is None or any(s is None for s in streams):
            raise RocJpegError(Status.INVALID_PARAMETER, "null stream handle")
        params = params or DecodeParams()
        fmt = OutputFormat(params.output_format)
        stream_params = [s.params for s in streams]
        for p in stream_params:
            self._host._validate(p)

        n_data = self.mesh.shape["data"]
        use_dev = self._device_entropy != "off"
        groups = {}
        for idx, p in enumerate(stream_params):
            key = (p.chroma_subsampling, p.picture_width, p.picture_height,
                   tuple(c.h_sampling_factor for c in p.components),
                   tuple(c.v_sampling_factor for c in p.components))
            if use_dev:
                from ..api import Decoder as _D
                key = key + (p.restart_interval, _D._huffman_digest(p))
            groups.setdefault(key, []).append(idx)

        results: List[Optional[DecodedImage]] = [None] * len(streams)
        self.last_error_flags = []
        for key, idxs in groups.items():
            plist = [stream_params[i] for i in idxs]
            p0 = plist[0]
            crop = params.crop_rectangle
            if crop is not None and not (
                    0 < crop.width <= p0.picture_width
                    and 0 < crop.height <= p0.picture_height):
                crop = None
            crop_key = (crop.left, crop.top, crop.right, crop.bottom) if crop else None

            if use_dev and self._wave_eligible(plist):
                self._decode_group_wave(plist, idxs, params, crop_key,
                                        results)
                continue

            coeffs = host_decode.decode_coefficients_batch(plist)
            # Pad the batch to a power-of-two bucket that is also a multiple
            # of the data-axis size, so every device holds whole images.
            pad_to = bucket_batch(max(len(plist), n_data))
            if pad_to % n_data:
                pad_to = -(-pad_to // n_data) * n_data
            y, u, v, qy, qu, qv = stack_group_inputs(plist, coeffs, pad_to)

            luma_blocks = p0.component_block_dims(0)
            chroma_blocks = (p0.component_block_dims(1)
                             if p0.num_components >= 3 else None)
            fn = _sharded_decode(self.mesh, p0.chroma_subsampling,
                                 p0.picture_width, p0.picture_height,
                                 luma_blocks, chroma_blocks, fmt, crop_key)
            space = self.mesh.shape["space"]

            def coeff_sh(blocks):
                if blocks is not None and blocks[0] % space == 0:
                    return NamedSharding(self.mesh, P("data", "space"))
                return NamedSharding(self.mesh, P("data"))

            y_sh = coeff_sh(luma_blocks)
            c_sh = coeff_sh(chroma_blocks)
            q_sh = NamedSharding(self.mesh, P("data"))
            args = [jax.device_put(a, s) for a, s in
                    ((y, y_sh), (u, c_sh), (v, c_sh),
                     (qy, q_sh), (qu, q_sh), (qv, q_sh))]
            outs = fn(*args)
            pitches = output_pitches(p0.chroma_subsampling, p0.picture_width,
                                     p0.picture_height, fmt,
                                     CropRectangle(*crop_key) if crop_key else None)
            for j, i in enumerate(idxs):
                img = DecodedImage.empty()
                for ci, (arr, pitch) in enumerate(zip(outs, pitches)):
                    img.channel[ci] = arr[j]
                    img.pitch[ci] = pitch
                results[i] = img
        return results

    # ------------------------------------------------------------------
    def decode_batched_local(self, streams: Sequence, params=None,
                             global_arrays: bool = False):
        """Multi-host decode: every process calls this with its OWN local
        streams (equal counts per process, one shape/table group); the
        global batch is their concatenation in process order. No image
        bytes ever cross hosts — the jpegDecodePerf per-thread file
        partitioning (jpegdecodeperf.cpp:245-252) lifted to processes.

        The decode program has no cross-shard communication (restart
        segments and images are independent), so by default the steady
        state runs on the PROCESS-LOCAL sub-mesh: each host jits and
        launches its own program over its own devices, and nothing crosses
        the host network per batch. Only the end-of-run metrics collective
        (multihost.allreduce_metrics) is multi-controller. Pass
        ``global_arrays=True`` to instead build globally-sharded arrays
        over the full mesh (jax.make_array_from_process_local_data) — only
        useful when a downstream consumer needs the whole batch as one
        global jax.Array, at the cost of per-call cross-process
        coordination.

        Returns (per_local_image_channels, pitches, err): channels as host
        numpy arrays for this process's images."""
        from ..ops import device_entropy as de

        params = params or DecodeParams()
        fmt = OutputFormat(params.output_format)
        plist = [s.params for s in streams]
        for p in plist:
            self._host._validate(p)
        p0 = plist[0]
        n_proc = jax.process_count()
        global_arrays = global_arrays and n_proc > 1
        work_mesh = self.mesh if (n_proc == 1 or global_arrays) \
            else self.mesh.local_mesh
        n_local = len(plist)
        # Devices this process's shard spreads over; the local batch is
        # padded so every device gets the same per-device image count.
        if global_arrays:
            dev_local = max(1, work_mesh.shape["data"] // n_proc)
        else:
            dev_local = work_mesh.shape["data"]
        local_batch = n_local
        if local_batch % dev_local:
            local_batch = -(-local_batch // dev_local) * dev_local
        padded = list(plist) + [plist[0]] * (local_batch - n_local)
        per_dev = local_batch // dev_local

        geom_local = de.GroupGeometry.from_params(p0, per_dev)
        dense, lanes, n_words, max_steps = _pack_mesh_lanes(
            padded, dev_local, per_dev, geom_local)
        n_lanes_dev = len(lanes["word_off"]) // dev_local

        crop = params.crop_rectangle
        if crop is not None and not (0 < crop.width <= p0.picture_width
                                     and 0 < crop.height <= p0.picture_height):
            crop = None
        crop_key = (crop.left, crop.top, crop.right, crop.bottom) if crop else None
        fn = _sharded_wave_decode(work_mesh, geom_local, n_lanes_dev,
                                  n_words, max_steps,
                                  p0.chroma_subsampling, p0.picture_width,
                                  p0.picture_height, fmt, crop_key)
        tables = de.DeviceScanTables.from_params(p0)

        def globalize(local, spec):
            if not global_arrays:
                return local
            from jax import make_array_from_process_local_data
            sh = NamedSharding(self.mesh, spec)
            return make_array_from_process_local_data(sh, local)

        lane = P("data")
        args = ([globalize(dense, lane)]
                + [globalize(lanes[k], lane) for k in
                   ("word_off", "img_base", "mcu_start", "mcu_count")]
                + [tables.lentab, tables.values]
                + [globalize(q, lane) for q in quant_rows(plist, local_batch)])
        out = fn(*args)
        outs, err = out[:-1], out[-1]
        pitches = output_pitches(p0.chroma_subsampling, p0.picture_width,
                                 p0.picture_height, fmt,
                                 CropRectangle(*crop_key) if crop_key
                                 else None)

        # Collect this process's images from the addressable output shards.
        def local_rows(arr):
            shards = sorted(arr.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            return np.concatenate([np.asarray(s.data) for s in shards])

        host_chans = [local_rows(a) for a in outs]
        per_image = []
        for i in range(n_local):
            per_image.append([c[i] for c in host_chans])
        return per_image, pitches, err

    # ------------------------------------------------------------------
    def _wave_eligible(self, plist) -> bool:
        """The on-device wave needs enough parallel segments to pay off
        (same policy as api.Decoder 'auto')."""
        segs = 0
        for p in plist:
            interleaved = len(p.scan_components) > 1
            total = p.num_mcus if interleaved else (
                ((p.picture_width + 7) // 8) * ((p.picture_height + 7) // 8))
            ri = p.restart_interval if p.restart_interval > 0 else total
            segs += (total + ri - 1) // ri
        return segs >= 64

    def _decode_group_wave(self, plist, idxs, params, crop_key, results):
        """Decode one group fully on-device, sharded over the 'data' axis:
        per-image-uniform lane packing, shard_map(wave + transform)."""
        from ..ops import device_entropy as de
        from ..types import LazyChannel

        fmt = OutputFormat(params.output_format)
        p0 = plist[0]
        n = len(plist)
        n_data = self.mesh.shape["data"]
        batch = bucket_batch(max(n, n_data))
        if batch % n_data:
            batch = -(-batch // n_data) * n_data
        padded = list(plist) + [plist[0]] * (batch - n)
        local_batch = batch // n_data

        geom_local = de.GroupGeometry.from_params(p0, local_batch)
        dense, lanes, n_words, max_steps = _pack_mesh_lanes(
            padded, n_data, local_batch, geom_local)
        n_lanes_local = len(lanes["word_off"]) // n_data

        fn = _sharded_wave_decode(self.mesh, geom_local, n_lanes_local,
                                  n_words, max_steps,
                                  p0.chroma_subsampling, p0.picture_width,
                                  p0.picture_height, fmt, crop_key)
        tables = de.DeviceScanTables.from_params(p0)
        out = fn(dense, lanes["word_off"], lanes["img_base"],
                 lanes["mcu_start"], lanes["mcu_count"],
                 tables.lentab, tables.values, *quant_rows(plist, batch))
        outs, err = out[:-1], out[-1]
        self.last_error_flags.append(err)
        pitches = output_pitches(p0.chroma_subsampling, p0.picture_width,
                                 p0.picture_height, fmt,
                                 CropRectangle(*crop_key) if crop_key
                                 else None)
        for j, i in enumerate(idxs):
            img = DecodedImage.empty()
            for ci, (arr, pitch) in enumerate(zip(outs, pitches)):
                img.channel[ci] = LazyChannel(arr, j)
                img.pitch[ci] = pitch
            results[i] = img
