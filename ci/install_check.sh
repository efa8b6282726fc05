#!/usr/bin/env bash
# Installed-package verification — the analog of the reference's
# rocjpeg-test package, which rebuilds the samples from the INSTALLED tree
# and runs them (test/CMakeLists.txt:53-207, .jenkins/common.groovy:27-59):
#
#   1. build the wheel (native host library bundled as package data)
#   2. install it into a clean venv (--system-site-packages for jax/numpy;
#      the wheel itself installs with --no-index — no network)
#   3. import + decode smoke FROM THE INSTALLED PACKAGE (neutral cwd)
#   4. run the test suite against the installed package
#      (ROCJPEG_TPU_INSTALLED=1 keeps the repo root off sys.path)
#   5. run the C ABI sample against the installed package
#      (ROCJPEG_TPU_ROOT pointing at the venv's site-packages)
set -euo pipefail
cd "$(dirname "$0")/.."
REPO="$PWD"
VENV="${ROCJPEG_TPU_VENV:-/tmp/rjt_install_venv}"

echo "== native library (bundled into the wheel) =="
make native capi

echo "== build wheel =="
rm -rf dist/ build/bdist* build/lib
python -m pip wheel . --no-deps --no-build-isolation -w dist/ -q
WHEEL=$(ls dist/rocjpeg_tpu-*.whl)
echo "built $WHEEL"

echo "== clean venv install =="
rm -rf "$VENV"
python -m venv --system-site-packages "$VENV"
# The CI interpreter is itself a venv, so --system-site-packages links to
# the BASE interpreter's site-packages; expose the parent env's packages
# (jax/numpy/pytest) via a .pth file.
PARENT_SITE=$(python -c "import sysconfig; print(sysconfig.get_paths()['purelib'])")
VENV_SITE=$("$VENV/bin/python" -c "import sysconfig; print(sysconfig.get_paths()['purelib'])")
echo "$PARENT_SITE" > "$VENV_SITE/_parent_env.pth"
"$VENV/bin/pip" install --no-index --no-deps -q "$WHEEL"

echo "== installed-package import + decode smoke =="
cd /tmp
JAX_PLATFORMS=cpu "$VENV/bin/python" - <<EOF
import os, sys
import rocjpeg_tpu
assert "$VENV" in rocjpeg_tpu.__file__, \
    f"resolved to {rocjpeg_tpu.__file__}, not the installed package"
from rocjpeg_tpu import api
from rocjpeg_tpu.runtime import host_decode
assert host_decode.backend_name() == "native", "bundled .so missing"
from rocjpeg_tpu.types import DecodeParams, OutputFormat
data = open("/root/reference/data/images/mug_420.jpg", "rb").read()
img = api.Decoder().decode(api.JpegStream(data), DecodeParams(OutputFormat.Y))
import numpy as np
y = np.asarray(img.channel[0])
assert y.shape == (2160, 3840), y.shape
print("installed-package decode ok:", rocjpeg_tpu.__file__)
EOF

echo "== test suite against the installed package =="
cd /tmp
ROCJPEG_TPU_INSTALLED=1 "$VENV/bin/python" -m pytest "$REPO/tests" -q -x \
    -p no:cacheprovider

echo "== C ABI sample against the installed package =="
SITE=$("$VENV/bin/python" -c "import sysconfig; print(sysconfig.get_paths()['purelib'])")
cd "$REPO"
ROCJPEG_TPU_ROOT="$SITE" JAX_PLATFORMS=cpu \
    ./build/jpegdecode_c -i /root/reference/data/images/mug_420.jpg

echo "install check: OK"
