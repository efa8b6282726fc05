#!/usr/bin/env python3
"""rocjpeg_tpu environment setup / dependency bootstrap.

The reference ships rocJPEG-setup.py, an OS-package bootstrapper that
verifies the driver stack (ROCm) and installs build/runtime dependencies
before the library is built (reference: rocJPEG-setup.py). This analog:

  1. verify the host toolchain (python >= 3.10, g++, make);
  2. verify the installed JAX (on a GPU host, with its CUDA plugin), and
     verify — or, with --install ON, pip-install — numpy (and pytest/build
     for --dev ON);
  3. build the native host library and the C ABI library;
  4. smoke-check: import the package, list JAX devices, decode one
     synthesized image.

By default NOTHING is installed — the script only reports what is missing
and the exact command to fix it (the operator decides when to touch the
network). Pass --install ON to run the pip commands. JAX itself is never
installed here: which build fits depends on the accelerator.

Usage:  python3 rocjpeg-tpu-setup.py [--install ON|OFF] [--dev ON|OFF]
"""

import argparse
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

# (module name, pip argv tail). Installs run as
# [sys.executable, -m, pip, install, *argv] so they target THIS interpreter.
RUNTIME_PKGS = [
    ("numpy", ["numpy"]),
]
DEV_PKGS = [
    ("pytest", ["pytest"]),
    ("build", ["build"]),
]


def _fix_str(argv) -> str:
    return "pip install " + " ".join(argv)

_failures = []


def check(ok: bool, what: str, fix: str = "") -> bool:
    mark = "ok " if ok else "MISSING"
    print(f"[{mark:7s}] {what}" + ("" if ok else f"  -> {fix}"))
    if not ok:
        _failures.append((what, fix))
    return ok


def have_module(name: str) -> bool:
    import importlib.util
    return importlib.util.find_spec(name) is not None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--install", default="OFF", choices=["ON", "OFF", "on", "off"],
                    help="run pip for missing Python deps (default OFF: report only)")
    ap.add_argument("--dev", default="OFF", choices=["ON", "OFF", "on", "off"],
                    help="also require the dev/test deps (pytest, build)")
    args = ap.parse_args()
    do_install = args.install.upper() == "ON"
    want_dev = args.dev.upper() == "ON"

    print("== rocjpeg_tpu setup ==")

    # 1. toolchain
    check(sys.version_info >= (3, 10), f"python {sys.version.split()[0]} (>= 3.10)",
          "install python3.10+")
    for tool in ("g++", "make"):
        check(shutil.which(tool) is not None, f"toolchain: {tool}",
              f"apt-get install {tool if tool != 'g++' else 'g++'}")

    # 2. python deps
    check(have_module("jax"), "python dep: jax",
          "install JAX for this host's accelerator (on a GPU host, with its "
          "CUDA plugin)")
    pkgs = RUNTIME_PKGS + (DEV_PKGS if want_dev else [])
    for mod, argv in pkgs:
        if not have_module(mod) and do_install:
            print(f"[install] {_fix_str(argv)}")
            subprocess.run([sys.executable, "-m", "pip", "install"] + argv,
                           check=False)
            # An in-process install leaves the import system's finder
            # caches stale; invalidate before re-probing or a successful
            # install is still reported MISSING.
            import importlib
            importlib.invalidate_caches()
        check(have_module(mod), f"python dep: {mod}", _fix_str(argv))

    if _failures:
        print(f"\n{len(_failures)} prerequisite(s) missing; fix the above "
              f"and re-run (or pass --install ON for the pip ones).")
        return 1

    # 3. native build
    print("\n== native build ==")
    r = subprocess.run(["make", "native", "capi"], cwd=REPO)
    if not check(r.returncode == 0, "make native capi", "inspect compiler output"):
        return 1

    # 4. smoke
    print("\n== smoke check ==")
    sys.path.insert(0, REPO)
    import jax
    import rocjpeg_tpu
    print(f"rocjpeg_tpu {rocjpeg_tpu.__version__}; "
          f"jax {jax.__version__}; backend={jax.default_backend()}; "
          f"devices={jax.devices()}")
    from rocjpeg_tpu import api
    from rocjpeg_tpu.testing import encoder
    from rocjpeg_tpu.types import DecodeParams, OutputFormat
    blob = encoder.encode_planes(encoder.random_planes("420", 256, 128, 0),
                                 "420", restart_interval=2)
    img = api.Decoder().decode(api.JpegStream(blob),
                               DecodeParams(OutputFormat.RGB))
    print(f"decoded a synthesized 256x128 image: "
          f"channel[0] shape {tuple(img.channel[0].shape)}")
    print("\nsetup complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
