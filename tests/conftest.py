"""Test configuration.

Tests run on the CPU, on a virtual 8-device mesh, so the multi-device
sharding path compiles and executes without accelerators (tests that need
a GPU carry the ``gpu`` marker and skip here). The env vars must be set
before the first ``import jax`` anywhere in the process.
"""

import os
import sys

# A GPU host runs the ``gpu``-marked tests with JAX_PLATFORMS=cuda,cpu.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# Install-verification mode (ci/install_check.sh): leave the repo root OFF
# sys.path so `import rocjpeg_tpu` resolves to the INSTALLED package — the
# analog of the reference's installed-tree test package
# (test/CMakeLists.txt:53-207).
if os.environ.get("ROCJPEG_TPU_INSTALLED") != "1":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import pytest  # noqa: E402

REFERENCE_IMAGES = "/root/reference/data/images"


@pytest.fixture(scope="session")
def corpus():
    """The bundled reference test corpus (BASELINE.md: data/images)."""
    import glob
    paths = sorted(glob.glob(os.path.join(REFERENCE_IMAGES, "*.jpg")))
    assert paths, "reference image corpus not found"
    return {os.path.splitext(os.path.basename(p))[0]: open(p, "rb").read()
            for p in paths}


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked ``gpu``; skips where there is none
    (decided here, at run time, never at import or collection)."""
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (on a GPU host: "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)")
