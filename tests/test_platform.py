"""Platform selection: which wave runs where, the device spec table, the
compile-cache location, the GPU kernel's lane quantum, and the smoke
script's refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from rocjpeg_tpu.core.bitstream import JpegStreamParser
from rocjpeg_tpu.kernels import wave_triton
from rocjpeg_tpu.ops import device_entropy as de
from rocjpeg_tpu.status import RocJpegError, Status
from rocjpeg_tpu.testing import encoder
from rocjpeg_tpu.types import spec_for_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,wave", [("gpu", "triton"),
                                           ("cpu", "jnp")])
def test_wave_backend_by_platform(monkeypatch, platform, wave):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert de.wave_backend() == wave


def test_wave_backend_has_no_override(monkeypatch):
    """No environment route to another wave or to an interpreted kernel."""
    monkeypatch.setenv("ROCJPEG_TPU_WAVE", "pallas-interpret")
    assert de.wave_backend() == "jnp"


class _FakeDevice:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


@pytest.mark.parametrize("platform,kind,lanes", [
    ("gpu", "NVIDIA H100 80GB HBM3", 32),
    ("cpu", "cpu", 8),
])
def test_spec_for_device_rows(platform, kind, lanes):
    spec = spec_for_device(_FakeDevice(platform, kind))
    assert spec.name == kind and spec.num_decode_lanes == lanes
    assert spec.can_convert_to_rgb and spec.can_roi_decode


def test_spec_for_device_unknown_platform_is_an_error():
    with pytest.raises(RocJpegError) as ei:
        spec_for_device(_FakeDevice("metal", "Apple M2"))
    assert ei.value.status == Status.NOT_INITIALIZED


def _cache_dir(env):
    code = ("import jax, rocjpeg_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_env_var_wins(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"))
    assert _cache_dir(env) == str(tmp_path / "c")


def test_compile_cache_defaults_into_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    assert _cache_dir(env) == os.path.join(ROOT, ".jax_cache")
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_lane_quantum_follows_kernel_block():
    q = de.lane_quantum()
    assert q % wave_triton.LANE_BLOCK == 0 and q % 128 == 0
    assert wave_triton.LANE_BLOCK == 32 * wave_triton.NUM_WARPS


@pytest.mark.parametrize("ri", [0, 3])
def test_packed_lanes_divide_into_kernel_blocks(ri):
    """Real and virtual restart packs pad lanes to the kernel's quantum
    (with at most 1/8 slack on the virtual path)."""
    blobs = [encoder.encode_planes(encoder.random_planes("420", 160, 96,
                                                         seed=s),
                                   "420", restart_interval=ri)
             for s in range(3)]
    plist = [JpegStreamParser().parse(b) for b in blobs]
    geom = de.GroupGeometry.from_params(plist[0], len(plist))
    if ri:
        packed = de.pack_segments(plist, geom.total_blocks)
        used = sum(-(-p.num_mcus // ri) for p in plist)
    else:
        packed, _, _ = de.pack_virtual_segments(plist, geom.total_blocks, 50)
        used = int(np.count_nonzero(packed.mcu_count))
    assert packed.n_lanes % de.lane_quantum() == 0
    assert used <= packed.n_lanes
    if not ri:
        assert packed.n_lanes <= max(de.lane_quantum(), used * 9 // 8 + 128)
    assert de.max_steps_bound(geom, packed) % wave_triton.UNROLL == 0


def test_kernel_rejects_ragged_lane_count():
    blob = encoder.encode_planes(encoder.random_planes("400", 64, 64, 0),
                                 "400", restart_interval=1)
    geom = de.GroupGeometry.from_params(JpegStreamParser().parse(blob), 1)
    with pytest.raises(ValueError):
        wave_triton.build_wave_kernel(geom, wave_triton.LANE_BLOCK + 32, 8,
                                      256)
    with pytest.raises(ValueError):
        wave_triton.build_wave_kernel(geom, wave_triton.LANE_BLOCK, 8, 255)


def test_chip_smoke_refuses_cpu():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.check_device(jax)
