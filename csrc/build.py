"""Build the native host library (librocjpeg_host.so).

Usage: python csrc/build.py
The library is placed next to rocjpeg_tpu/runtime/native.py, which also
attempts this build automatically on first import if g++ is available.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "..", "rocjpeg_tpu", "runtime", "librocjpeg_host.so")
SRC = os.path.join(HERE, "rocjpeg_entropy.cpp")


def build(verbose: bool = True) -> str:
    # Build to a private name, then rename: concurrent first imports (test
    # workers) never load a half-written library.
    tmp = f"{OUT}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-fno-exceptions",
        SRC, "-o", tmp,
    ]
    if verbose:
        print("+", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, OUT)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return OUT


if __name__ == "__main__":
    path = build()
    print("built", path)
    sys.exit(0)
