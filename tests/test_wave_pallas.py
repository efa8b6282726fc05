"""The GPU wave kernel (Pallas, Triton route) under the Pallas interpreter.

Pins kernels/wave_triton.py bit-exactly to the host entropy oracle
(core/entropy.py) across the CSS x restart x long-code x corrupt-stream
matrix, on the CPU — and to the plain ``jnp`` wave it replaces on the GPU,
coefficients and error flags alike (tests/test_device_entropy.py covers the
``jnp`` wave against the oracle).

The interpreter executes the kernel's while loop step by step, so wall time
scales with the longest lane's symbol count: the images here are
deliberately low-entropy (smooth gradients -> few AC coefficients) and
small. Dense/noisy payloads are covered by one long-code case.
"""

import jax
import numpy as np
import pytest

from rocjpeg_tpu.core import entropy
from rocjpeg_tpu.core.bitstream import JpegStreamParser
from rocjpeg_tpu.kernels import wave_triton
from rocjpeg_tpu.ops import device_entropy as de
from rocjpeg_tpu.testing import encoder


def run_kernel_interpret(plist, tables, packed):
    """(coeffs, err, geom) of the Triton wave kernel run under the
    interpreter, and the same of the jnp wave on identical inputs."""
    geom = de.GroupGeometry.from_params(plist[0], len(plist))
    max_steps = de.max_steps_bound(geom, packed)
    args = [packed.dense, packed.word_off, packed.img_base,
            packed.mcu_start, packed.mcu_count, tables.lentab, tables.values]
    if tables.n_banks > 1:
        args.append(packed.lane_bank)
    kern = wave_triton.build_wave_kernel(geom, packed.n_lanes,
                                         packed.n_words, max_steps,
                                         tables.n_banks, interpret=True)
    out, err = jax.jit(kern)(*args)
    ref_out, ref_err, _ = de.decode_coefficients_on_device(plist, tables,
                                                           packed)
    size = geom.batch * geom.total_blocks * 64
    np.testing.assert_array_equal(np.asarray(out)[:size],
                                  np.asarray(ref_out)[:size])
    np.testing.assert_array_equal(np.asarray(err), np.asarray(ref_err))
    return out, err, geom


def smooth_planes(css, width, height, seed=0):
    """Low-entropy planes: a gradient plus mild blockwise offsets, so each
    8x8 block quantizes to a handful of nonzero coefficients."""
    rng = np.random.default_rng(seed)
    hf, vf = {"444": (1, 1), "440": (1, 2), "422": (2, 1),
              "420": (2, 2), "411": (4, 1), "400": (1, 1)}[css]

    def grad(h, w):
        y = np.linspace(0, 120, h, dtype=np.float32)[:, None]
        x = np.linspace(0, 90, w, dtype=np.float32)[None, :]
        noise = rng.integers(0, 6, (h, w))
        return np.clip(60 + y + x + noise, 0, 255).astype(np.uint8)

    planes = [grad(height, width)]
    if css != "400":
        planes.append(grad(height // vf, width // hf))
        planes.append(grad(height // vf, width // hf))
    return planes


def _check_wave(blobs):
    plist = [JpegStreamParser().parse(b) for b in blobs]
    tables = de.DeviceScanTables.from_params(plist[0])
    geom0 = de.GroupGeometry.from_params(plist[0], len(plist))
    packed = de.pack_segments(plist, geom0.total_blocks)
    out, err, geom = run_kernel_interpret(plist, tables, packed)
    assert not bool(np.asarray(err).any())
    comps = de.unflatten_coefficients(out, geom, plist[0])
    for i, p in enumerate(plist):
        ref = entropy.decode_scan(p)
        for ci in range(len(ref)):
            a = ref[ci]
            b = np.asarray(comps[ci][i])[:a.shape[0], :a.shape[1]]
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("css", ["444", "440", "422", "420", "411", "400"])
def test_pallas_wave_css_matrix(css):
    blobs = [encoder.encode_planes(smooth_planes(css, 64, 48, seed=s), css,
                                   restart_interval=1) for s in range(2)]
    _check_wave(blobs)


@pytest.mark.parametrize("ri", [0, 1, 3])
def test_pallas_wave_restart_intervals(ri):
    # ri=0: one segment carries the whole image (the DRI=0 lane shape).
    blobs = [encoder.encode_planes(smooth_planes("420", 48, 32, seed=s),
                                   "420", restart_interval=ri)
             for s in range(2)]
    _check_wave(blobs)


def test_pallas_wave_dense_long_codes():
    # Max-magnitude coefficients force 16-bit AC codes + 10-bit extends —
    # the deepest code paths in the matcher.
    rng = np.random.default_rng(6)
    coeffs = [rng.choice([-1023, 1023, -255, 255],
                         (2, 8, 64)).astype(np.int32)]
    data = encoder.encode_coefficients(coeffs, encoder.SAMPLING["400"],
                                       64, 16, [encoder.QTABLE_LUMA], [0],
                                       restart_interval=1)
    _check_wave([data])


def test_pallas_wave_detects_corrupt_scan():
    blob = encoder.encode_planes(smooth_planes("420", 48, 32, seed=1),
                                 "420", restart_interval=1)
    p = JpegStreamParser().parse(blob)
    bad = bytearray(p.slice_data)
    if len(bad) > 48:
        for i in range(16, min(48, len(bad))):
            bad[i] = 0xFF if i % 2 else 0xD9
    p.slice_data = bytes(bad)
    tables = de.DeviceScanTables.from_params(p)
    geom0 = de.GroupGeometry.from_params(p, 1)
    try:
        packed = de.pack_segments([p], geom0.total_blocks)
    except Exception:
        return  # host-side segmentation already rejected it — fine
    _, err, _ = run_kernel_interpret([p], tables, packed)
    assert bool(np.asarray(err).any())


@pytest.mark.gpu
def test_pallas_wave_compiled_on_gpu(gpu_device):
    """The kernel as compiled for the card (not interpreted) against the
    ``jnp`` wave on the same card."""
    blobs = [encoder.encode_planes(encoder.random_planes("420", 256, 192,
                                                         seed=s),
                                   "420", restart_interval=2,
                                   table_variant=s % 2) for s in range(4)]
    plist = [JpegStreamParser().parse(b) for b in blobs]
    tables, bank_of = de.DeviceScanTables.from_params_banked(plist)
    geom = de.GroupGeometry.from_params(plist[0], len(plist))
    packed = de.pack_segments(plist, geom.total_blocks, bank_of=bank_of)
    max_steps = de.max_steps_bound(geom, packed)
    args = [packed.dense, packed.word_off, packed.img_base,
            packed.mcu_start, packed.mcu_count, tables.lentab,
            tables.values, packed.lane_bank]
    size = geom.batch * geom.total_blocks * 64
    with jax.default_device(gpu_device):
        kern = wave_triton.build_wave_kernel(
            geom, packed.n_lanes, packed.n_words, max_steps, tables.n_banks)
        out, err = jax.jit(kern)(*args)
        ref_out, ref_err = de._compiled_wave(
            "jnp", geom, packed.n_lanes, packed.n_words, max_steps,
            tables.n_banks)(*args)
    np.testing.assert_array_equal(np.asarray(out)[:size],
                                  np.asarray(ref_out)[:size])
    np.testing.assert_array_equal(np.asarray(err), np.asarray(ref_err))
