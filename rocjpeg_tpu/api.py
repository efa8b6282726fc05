"""Session API — the mirror of the 9-function rocJPEG C API.

Mapping (reference api/rocjpeg.h:204-343, src/rocjpeg_api.cpp):

- ``rocJpegStreamCreate/Parse/Destroy`` → :class:`JpegStream` (ctor / ``parse``
  / GC), wrapping the parser session like RocJpegStreamParserHandle
  (src/rocjpeg_api_stream_handle.h:37-81).
- ``rocJpegCreate/Destroy``            → :class:`Decoder` ctor / GC, like
  RocJpegDecoderHandle (src/rocjpeg_api_decoder_handle.h:36-86).
- ``rocJpegGetImageInfo``              → :meth:`Decoder.get_image_info`
  (semantics of src/rocjpeg_decoder.cpp:307-358).
- ``rocJpegDecode``                    → :meth:`Decoder.decode`
  (src/rocjpeg_decoder.cpp:104-185).
- ``rocJpegDecodeBatched``             → :meth:`Decoder.decode_batched`
  (src/rocjpeg_decoder.cpp:196-292).
- ``rocJpegGetErrorName``              → :func:`rocjpeg_tpu.status.get_error_name`.

Architecture: the host entropy front-end (runtime/host_decode) produces
coefficient planes; the jitted XLA pipeline (pipeline.py) does dequant,
IDCT, upsampling, color conversion, and layout on device. Where the
reference chunks a batch by ``num_jpeg_cores`` (decoder.cpp:208-218), this
framework groups the whole batch by shape (the JpegStreamKey idea,
vaapi_decoder.h:223-265) and decodes each group as one batched XLA program —
the device's "cores" are the lanes of a single fused kernel.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

import jax

from .core.bitstream import JpegStreamParams, JpegStreamParser
from .pipeline import decode_group
from .runtime import host_decode
from .status import RocJpegError, Status
from .types import (Backend, ChromaSubsampling, CropRectangle, DecodedImage,
                    DecodeParams, ImageInfo, OutputFormat, TpuDecodeSpec)
from .types import spec_for_device as types_spec_for_device

CSS = ChromaSubsampling


def write_channel_into(arr, dest, pitch: int) -> None:
    """Copy one decoded channel into a caller buffer honoring the caller's
    pitch — CopyChannel semantics (src/rocjpeg_decoder.cpp:372-399), host
    side. ``dest`` is a writable numpy buffer or a raw pointer integer (the
    C ABI path); ``pitch`` is the destination row pitch in bytes."""
    import ctypes

    import numpy as np

    src = np.ascontiguousarray(np.asarray(arr))
    if src.ndim == 1:
        src = src[None, :]
    h, row_bytes = src.shape[0], src.shape[1] * src.itemsize
    if pitch < row_bytes:
        raise RocJpegError(Status.INVALID_PARAMETER,
                           f"destination pitch {pitch} < row size {row_bytes}")
    if isinstance(dest, (int, np.integer)):
        base = int(dest)
        if pitch == row_bytes:
            ctypes.memmove(base, src.ctypes.data, h * row_bytes)
        else:
            for r in range(h):
                ctypes.memmove(base + r * pitch,
                               src.ctypes.data + r * row_bytes, row_bytes)
    elif isinstance(dest, np.ndarray):
        if not dest.flags.writeable:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               "destination buffer is read-only")
        if not dest.flags.c_contiguous:
            # reshape(-1) on a non-contiguous view COPIES — the strided
            # write would land in the copy and the caller's buffer would
            # silently stay untouched. Pitch is how callers express padded
            # layouts here (pass the base buffer + pitch, not a sliced
            # view), so reject rather than guess.
            raise RocJpegError(Status.INVALID_PARAMETER,
                               "destination buffer must be C-contiguous "
                               "(pass the base buffer and express padding "
                               "via pitch)")
        flat = dest.reshape(-1).view(np.uint8)
        need = (h - 1) * pitch + row_bytes
        if flat.nbytes < need:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"destination buffer {flat.nbytes}B < {need}B")
        rows = np.lib.stride_tricks.as_strided(
            flat, shape=(h, row_bytes), strides=(pitch, 1), subok=False)
        rows[:] = src.view(np.uint8).reshape(h, row_bytes)
    else:
        raise RocJpegError(Status.INVALID_PARAMETER, "null destination channel")


class JpegStream:
    """A parsed-JPEG session handle (RocJpegStreamHandle analog)."""

    def __init__(self, data: Optional[bytes] = None):
        self._parser = JpegStreamParser()
        self._parsed = False
        if data is not None:
            self.parse(data)

    def parse(self, data: bytes) -> "JpegStream":
        """rocJpegStreamParse analog; raises RocJpegError(BAD_JPEG) on
        malformed input."""
        self._parser.parse(data)
        self._parsed = True
        return self

    @property
    def params(self) -> JpegStreamParams:
        """Parsed stream parameters (rocJpegGetImageInfo source data):
        dimensions, component sampling factors, quant/Huffman tables,
        restart interval, and the entropy-coded scan span. Raises if the
        stream has not been parsed yet."""
        return self._parser.params


class Decoder:
    """A decode session handle (RocJpegHandle analog).

    Unlike the reference handle — which serializes all decodes behind a
    mutex (decoder.cpp:105) — a Decoder is safe for concurrent use; only
    spec/device state is shared and it is immutable after init.
    """

    def __init__(self, backend: Backend = Backend.HARDWARE, device_id: int = 0,
                 spec: Optional[TpuDecodeSpec] = None,
                 device_entropy: str = "auto",
                 check_errors: bool = True):
        """device_entropy: 'on' | 'off' | 'auto'. 'on' runs Huffman decode
        on-chip (ops/device_entropy.py) whenever the group's images share
        Huffman tables; 'auto' additionally requires enough restart segments
        (>= 64) for the wave to pay off; 'off' always uses the host path.

        check_errors: when True (default, reference-parity: a corrupt scan
        raises BAD_JPEG like rocJpegDecode returning an error status), each
        decode_batched call materializes the on-device error flags — one
        host<->device sync per call. Set False for peak-throughput pipelines;
        corrupt streams then decode to garbage pixels and the flags remain
        available on ``Decoder.last_error_flags`` for lazy inspection."""
        if backend == Backend.HYBRID:
            # Reference parity: HYBRID is NOT_IMPLEMENTED
            # (src/rocjpeg_decoder.cpp:84-88).
            raise RocJpegError(Status.NOT_IMPLEMENTED,
                               "HYBRID backend is not implemented")
        if backend != Backend.HARDWARE:
            raise RocJpegError(Status.INVALID_PARAMETER, "unknown backend")
        devices = jax.devices()
        if device_id < 0 or device_id >= len(devices):
            # InitHIP device-count check (decoder.cpp:48-57).
            raise RocJpegError(
                Status.NOT_INITIALIZED,
                f"device_id {device_id} out of range ({len(devices)} devices)")
        self._device = devices[device_id]
        self._spec = spec or types_spec_for_device(self._device)
        if self._device.platform == "gpu":
            # The device path needs the native packer and index walker;
            # never fall back to the Python host path on an accelerator.
            host_decode.require_native()
        if device_entropy not in ("on", "off", "auto"):
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"bad device_entropy mode {device_entropy!r}")
        self._device_entropy = device_entropy
        self._check_errors = check_errors
        # Per-thread error-flag capture: the docstring invites concurrent
        # decode calls, so the flags must not be shared state (reference
        # captures errors per *handle*, api_decoder_handle.h:77 — here one
        # handle serves many threads, so capture per handle × thread).
        self._tls = threading.local()
        self._lock = threading.Lock()
        # Self-throttling async pipeline: decode_batched returns without
        # waiting for the device, but keeps at most ``max_inflight`` wave
        # submissions outstanding (two is enough to overlap host and
        # device work, and bounds in-flight device memory).
        # ``_outstanding`` counts DISPATCHED programs, reserved before the
        # dispatch happens — a reservation, not a post-hoc append — so the
        # bound holds under concurrent callers (two threads appending after
        # dispatching could otherwise briefly queue 4 programs).
        self._max_inflight = 2
        self._inflight: list = []
        self._outstanding = 0
        # Signals token registration / slot release, so a thread that found
        # every slot reserved-but-unregistered waits instead of spin-polling
        # for the whole of another thread's (possibly multi-second) dispatch.
        self._slot_cv = threading.Condition(self._lock)

    @property
    def spec(self) -> TpuDecodeSpec:
        """GetCurrentVcnJpegSpec analog (vaapi_decoder.h:337)."""
        return self._spec

    @property
    def last_error_flags(self) -> list:
        """Device error flags from the calling thread's most recent
        decode_batched call (empty if that call used the host path)."""
        return getattr(self._tls, "error_flags", [])

    @last_error_flags.setter
    def last_error_flags(self, flags: list) -> None:
        self._tls.error_flags = flags

    @property
    def last_paths(self) -> list:
        """Per-chunk (path, batch_indices) pairs from the calling thread's
        most recent decode_batched call. ``path`` is one of ``'host'`` (host
        entropy decode + coefficient upload), ``'wave'`` (device wave over
        real restart lanes), or ``'wave-virtual'`` (host index walk +
        virtual restarts). Lets tools and benches report which entropy path
        served each group alongside every recorded number."""
        return getattr(self._tls, "paths", [])

    def last_failed_indices(self) -> list:
        """Batch indices of images whose scans the on-device wave flagged
        as corrupt in the calling thread's most recent decode_batched call.

        Materializes the device error flags (one sync). This is the lazy
        (check_errors=False) route to the same per-image attribution the
        check_errors=True path reports in its BAD_JPEG message — the analog
        of the reference's naturally-attributing per-image drain loop
        (src/rocjpeg_decoder.cpp:220-286)."""
        import numpy as np
        bad = []
        for err, lane_img, idxs in getattr(self._tls, "error_lanes", []):
            flags = np.asarray(err)
            if not flags.any():
                continue
            lanes = np.nonzero(flags.reshape(-1))[0]
            for li in np.unique(lane_img[lanes]):
                if 0 <= li < len(idxs):
                    bad.append(idxs[li])
        return sorted(set(bad))

    # ------------------------------------------------------------------
    def get_image_info(self, stream: JpegStream) -> ImageInfo:
        """rocJpegGetImageInfo analog; exact channel-dimension semantics of
        src/rocjpeg_decoder.cpp:307-358 (floor-divided chroma dims, zeroed
        channels for 4:0:0, 4:1:1 reported with quarter-width chroma)."""
        if stream is None:
            raise RocJpegError(Status.INVALID_PARAMETER, "stream is None")
        p = stream.params
        w0, h0 = p.picture_width, p.picture_height
        widths = [w0, 0, 0, 0]
        heights = [h0, 0, 0, 0]
        css = p.chroma_subsampling
        if css == CSS.CSS_444:
            widths[1] = widths[2] = w0
            heights[1] = heights[2] = h0
        elif css == CSS.CSS_440:
            widths[1] = widths[2] = w0
            heights[1] = heights[2] = h0 >> 1
        elif css == CSS.CSS_422:
            widths[1] = widths[2] = w0 >> 1
            heights[1] = heights[2] = h0
        elif css == CSS.CSS_420:
            widths[1] = widths[2] = w0 >> 1
            heights[1] = heights[2] = h0 >> 1
        elif css == CSS.CSS_411:
            widths[1] = widths[2] = w0 >> 2
            heights[1] = heights[2] = h0
        # CSS_400 / UNKNOWN leave chroma zeroed.
        return ImageInfo(num_components=p.num_components, subsampling=css,
                         widths=tuple(widths), heights=tuple(heights))

    # ------------------------------------------------------------------
    def _validate(self, p: JpegStreamParams) -> None:
        """Resolution/subsampling validation, mirroring SubmitDecode
        (vaapi_decoder.cpp:586-592 and the surface-format switch default)."""
        s = self._spec
        if (p.picture_width < s.min_width or p.picture_height < s.min_height
                or p.picture_width > s.max_width
                or p.picture_height > s.max_height):
            raise RocJpegError(Status.JPEG_NOT_SUPPORTED,
                               "the JPEG image resolution is not supported")
        if p.chroma_subsampling in (CSS.CSS_411, CSS.CSS_UNKNOWN):
            raise RocJpegError(Status.JPEG_NOT_SUPPORTED,
                               "the chroma subsampling is not supported")

    @staticmethod
    def _huffman_digest(p: JpegStreamParams) -> int:
        """Cheap Huffman-table identity for group keys, memoized on the
        params object (rebuilding decode tables per stream per call costs
        ~0.2ms each)."""
        d = getattr(p, "_huff_digest", None)
        if d is None:
            parts = []
            for tid, t in enumerate(p.huffman_tables):
                if t is None or not p.load_huffman_table[tid]:
                    parts.append(b"-")
                else:
                    parts.append(bytes(t.num_dc_codes) + bytes(t.dc_values)
                                 + bytes(t.num_ac_codes) + bytes(t.ac_values))
            d = hash(b"|".join(parts))
            try:
                p._huff_digest = d
            except Exception:
                pass
        return d

    def _virtual_k(self, plist) -> Optional[int]:
        """Virtual-restart record interval (minimum symbols per lane) for
        this group, or None.

        DRI=0 scans have no restart lanes for the wave; when the native
        index pass is available, the host walks each stream once recording
        bit offsets + MCU indices + DC predictors at symbol-balanced MCU
        boundaries, and the wave decodes those virtual segments in parallel
        (ops/device_entropy.py pack_virtual_segments). Requires every image
        in the group to be restart-free (groups already share Huffman
        tables by key)."""
        if not all(p.restart_interval == 0 for p in plist):
            return None
        if host_decode.native_index_module() is None:
            return None
        import os
        # Default 768 symbols/lane: fewer virtual lanes means fewer walker
        # record events, less per-lane host bookkeeping, and a smaller lane
        # grid on device; more lanes give the GPU wave more parallelism.
        # Not yet tuned on a GPU host (ROADMAP A3).
        return max(1, int(os.environ.get("ROCJPEG_TPU_VSYMS", "768")))

    def _group_device_eligible(self, plist, virtual_k=None) -> bool:
        """Whether the on-device entropy wave should decode this group."""
        if self._device_entropy == "on":
            return True
        # 'auto': worth it only with enough parallel lanes (restart segments
        # — real or virtual — across the group), else the host path wins.
        segs = 0
        for p in plist:
            interleaved = len(p.scan_components) > 1
            nslots = (sum(c.h_sampling_factor * c.v_sampling_factor
                          for c in p.components) if interleaved else 1)
            total = p.num_mcus if interleaved else (
                ((p.picture_width + 7) // 8) * ((p.picture_height + 7) // 8))
            if p.restart_interval > 0:
                segs += -(-total // p.restart_interval)
            elif virtual_k:
                # Virtual lanes: >= 2 symbols per block (DC + EOB) is the
                # conservative per-MCU symbol floor.
                segs += total * nslots * 2 // virtual_k
            else:
                segs += 1
        return segs >= 64

    def _acquire_slot(self) -> None:
        """Reserve one of the ``max_inflight`` device-program slots,
        draining (blocking on) the oldest outstanding submission when the
        queue is full. Blocking happens OUTSIDE the lock so other threads
        keep packing while this one waits on the device."""
        while True:
            with self._lock:
                if self._outstanding < self._max_inflight:
                    self._outstanding += 1
                    return
                tok = self._inflight.pop(0) if self._inflight else None
                if tok is None:
                    # Slots are reserved but their tokens not yet registered
                    # (another thread is mid-dispatch, which can include a
                    # multi-second host entropy pass): wait for the next
                    # registration/release instead of spin-polling through
                    # it. The timeout is belt-and-braces against a lost
                    # notify; the loop re-checks state either way.
                    self._slot_cv.wait(timeout=0.05)
                    continue
            # The popped token owns one reservation; release it even when
            # the program failed asynchronously (block_until_ready raises)
            # — a leaked reservation would hang the handle forever once
            # max_inflight failures accumulate.
            try:
                tok.block_until_ready()
            finally:
                with self._lock:
                    self._outstanding -= 1
                    self._slot_cv.notify_all()

    def _register_token(self, tok) -> None:
        with self._lock:
            self._inflight.append(tok)
            self._slot_cv.notify_all()

    def _release_slot(self) -> None:
        with self._lock:
            self._outstanding -= 1
            self._slot_cv.notify_all()

    def synchronize(self) -> None:
        """Drain every outstanding async submission from this handle — the
        ``hipStreamSynchronize`` analog (src/rocjpeg_decoder.cpp:183,:290)."""
        while True:
            with self._lock:
                tok = self._inflight.pop(0) if self._inflight else None
            if tok is None:
                return
            try:
                tok.block_until_ready()
            finally:
                with self._lock:
                    self._outstanding -= 1
                    self._slot_cv.notify_all()

    def decode(self, stream: JpegStream,
               params: Optional[DecodeParams] = None) -> DecodedImage:
        """rocJpegDecode analog. Returns a DecodedImage whose channels are
        device (JAX) arrays; use np.asarray to fetch to host."""
        return self.decode_batched([stream], params)[0]

    def decode_into(self, streams, dests,
                    params: Optional[DecodeParams] = None) -> None:
        """Decode into CALLER-ALLOCATED destination buffers — the
        reference's core output contract (``RocJpegImage``,
        api/rocjpeg.h:104-107): the caller owns the memory and hands the
        decoder per-channel buffers plus row pitches; the decoder writes
        each decoded plane honoring the pitch (copy semantics of
        src/rocjpeg_decoder.cpp:372-399, here host-side since the device is
        reached through JAX rather than pointer-visible VRAM).

        Accepts a single (stream, dest) pair or parallel sequences. Each
        dest is a :class:`~rocjpeg_tpu.types.DecodedImage` (or any object
        with ``channel``/``pitch`` lists) whose ``channel[ci]`` is a
        preallocated writable numpy buffer — or a raw pointer integer for
        C callers — and ``pitch[ci]`` the caller's row pitch in bytes
        (>= the row size; larger pitches leave the slack bytes untouched,
        exactly like hipMemcpy2D with dpitch > width).

        Raises RocJpegError(INVALID_PARAMETER) when channel 0 is missing,
        a pitch is below the row size, or a numpy buffer is too small for
        ``(rows - 1) * pitch + row_bytes``. Channels the caller did not
        allocate (None) are skipped, except channel 0.
        """
        single = isinstance(streams, JpegStream)
        if single:
            streams, dests = [streams], [dests]
        if len(dests) != len(streams):
            raise RocJpegError(Status.INVALID_PARAMETER,
                               "streams/dests length mismatch")
        images = self.decode_batched(list(streams), params)
        from .types import MAX_COMPONENT
        for img, dest in zip(images, dests):
            chans = dest.channel
            pitches = dest.pitch
            for ci in range(MAX_COMPONENT):
                if img.channel[ci] is None:
                    continue
                d = chans[ci] if ci < len(chans) else None
                # np.integer included: an np.int64(0) pointer must hit the
                # null check, not fall through to a memmove to address 0.
                null_ptr = isinstance(d, (int, np.integer)) and int(d) == 0
                if d is None or null_ptr:
                    if ci == 0:
                        raise RocJpegError(Status.INVALID_PARAMETER,
                                           "null destination channel 0")
                    continue
                write_channel_into(img.channel[ci], d, int(pitches[ci]))

    def decode_batched(self, streams: Sequence[JpegStream],
                       params: Optional[DecodeParams] = None
                       ) -> List[DecodedImage]:
        """rocJpegDecodeBatched analog: shape-group the batch, entropy-decode
        on the host (threaded native backend), run one batched XLA program
        per group."""
        if streams is None or any(s is None for s in streams):
            raise RocJpegError(Status.INVALID_PARAMETER, "null stream handle")
        params = params or DecodeParams()
        fmt = OutputFormat(params.output_format)
        stream_params = [s.params for s in streams]
        for p in stream_params:
            self._validate(p)

        # Shape grouping (JpegStreamKey analog: css + dims; quant AND
        # Huffman tables are data, not shape — per-image Huffman tables
        # ride the wave as banks, pipeline.decode_group_device_entropy).
        use_dev = self._device_entropy != "off"
        groups = {}
        for idx, p in enumerate(stream_params):
            key = (p.chroma_subsampling, p.picture_width, p.picture_height,
                   tuple(c.h_sampling_factor for c in p.components),
                   tuple(c.v_sampling_factor for c in p.components))
            groups.setdefault(key, []).append(idx)
        # Chunk each shape group by the spec's lane budget — the analog of
        # the reference chunking its batch by num_jpeg_cores
        # (src/rocjpeg_decoder.cpp:208-218). One XLA program per chunk
        # bounds in-flight HBM (coefficients + outputs) for huge batches
        # while small batches still run as one program.
        chunk_w = max(1, int(self._spec.num_decode_lanes))
        chunks = []
        for idxs in groups.values():
            for lo in range(0, len(idxs), chunk_w):
                chunks.append(idxs[lo:lo + chunk_w])

        results: List[Optional[DecodedImage]] = [None] * len(streams)
        err_flags = []
        err_lanes = []  # (err, lane_img, global idxs) per device-path chunk
        paths = []      # (entropy path, global idxs) per chunk
        # jax.default_device carries measurable per-call overhead; only pay
        # it when targeting a non-default device.
        import contextlib
        dev_ctx = (jax.default_device(self._device)
                   if self._device != jax.devices()[0]
                   else contextlib.nullcontext())
        with dev_ctx:
            for idxs in chunks:
                # Throttle BEFORE dispatching each chunk: reserve a device-
                # program slot (draining the oldest submission if both are
                # taken) so at most max_inflight programs are ever queued,
                # across all paths and threads; for multi-chunk batches this
                # also bounds in-flight HBM to ~max_inflight chunks.
                self._acquire_slot()
                registered = False
                try:
                    plist = [stream_params[i] for i in idxs]
                    # Normalize the crop per group: an invalid ROI decodes
                    # the full image (decoder.cpp:123-131) and must not
                    # create extra jit-cache entries.
                    p0 = plist[0]
                    crop = params.crop_rectangle
                    if crop is not None and not (
                            0 < crop.width <= p0.picture_width
                            and 0 < crop.height <= p0.picture_height):
                        crop = None
                    vk = self._virtual_k(plist) if use_dev else None
                    per_image = None
                    if use_dev and self._group_device_eligible(plist, vk):
                        from .pipeline import decode_group_device_entropy
                        try:
                            per_image, err, lane_img = \
                                decode_group_device_entropy(
                                    plist, fmt, crop, virtual_k=vk)
                            from .pipeline import last_entropy_path
                            paths.append((last_entropy_path(), idxs))
                            err_flags.append(err)
                            err_lanes.append((err, lane_img, idxs))
                            self._register_token(err)
                            registered = True
                        except RocJpegError as exc:
                            # Fall back to the host path when the group
                            # exceeds the wave's table-bank capacity, or
                            # when the virtual-restart index walk rejected
                            # a stream (the host decoder reports corrupt
                            # scans precisely).
                            if (vk is None and
                                    exc.status != Status.JPEG_NOT_SUPPORTED):
                                raise
                            per_image = None
                    if per_image is None:
                        paths.append(("host", idxs))
                        coeffs = host_decode.decode_coefficients_batch(plist)
                        per_image = decode_group(plist, coeffs, fmt, crop)
                        # Host-path submissions never sync in this call, so
                        # they need explicit backpressure tokens too (the
                        # device path's token is its err-flag array above);
                        # blocking on one channel drains the chunk's whole
                        # batched program.
                        self._register_token(per_image[0][0][0])
                        registered = True
                finally:
                    if not registered:
                        self._release_slot()
                for i, chans in zip(idxs, per_image):
                    img = DecodedImage.empty()
                    for ci, (arr, pitch) in enumerate(chans):
                        img.channel[ci] = arr
                        img.pitch[ci] = pitch
                    results[i] = img
        # One deferred error check for the whole call (single sync), after
        # every group has been dispatched asynchronously.
        self.last_error_flags = err_flags
        self._tls.error_lanes = err_lanes
        self._tls.paths = paths
        if self._check_errors and err_flags:
            import numpy as np
            if any(bool(np.asarray(e).any()) for e in err_flags):
                bad = self.last_failed_indices()
                raise RocJpegError(
                    Status.BAD_JPEG,
                    "on-device entropy decode failed (corrupt scan) in "
                    f"batch image(s) {bad}")
        return results
