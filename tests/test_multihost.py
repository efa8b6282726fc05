"""True multi-process mesh test: two JAX processes (4 virtual CPU devices
each) form one 8-device mesh; every process feeds its own corpus shard and
the sharded wave pipeline decodes the global batch collectively. Verifies
per-host outputs bit-exact vs golden — the multi-host jpegDecodePerf layout
(per-host input pipeline, no cross-host image bytes; SURVEY.md §2.4)."""

import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.distributed.initialize(coordinator_address=coord,
                           num_processes=nproc, process_id=pid)
import numpy as np
from rocjpeg_tpu import api
from rocjpeg_tpu.core import golden
from rocjpeg_tpu.dist import mesh as mesh_lib, multihost, sharding
from rocjpeg_tpu.testing import encoder
from rocjpeg_tpu.types import DecodeParams, OutputFormat

assert jax.process_count() == nproc
assert len(jax.devices()) == 4 * nproc

# Deterministic global corpus; each process takes its shard.
blobs = [encoder.encode_planes(
    encoder.random_planes("420", 128, 96, seed=s), "420",
    restart_interval=4) for s in range(8)]
local = multihost.shard_files_for_host(list(range(len(blobs))))
local_blobs = [blobs[i] for i in local]

md = sharding.MeshDecoder(mesh=mesh_lib.make_mesh(space=1))
# Both steady-state layouts: the default process-local sub-mesh program
# (no cross-host launch per batch) and the global-arrays path (one
# globally-sharded jax.Array over the full mesh).
for global_arrays in (False, True):
    per_image, pitches, err = md.decode_batched_local(
        [api.JpegStream(b) for b in local_blobs],
        DecodeParams(OutputFormat.RGB), global_arrays=global_arrays)

    for b, chans in zip(local_blobs, per_image):
        (ref, pitch), = golden.decode(b, OutputFormat.RGB)
        np.testing.assert_array_equal(chans[0], ref)
        assert pitches[0] == pitch

img, mpix, secs = multihost.allreduce_metrics(len(local_blobs), 1.0, 0.5)
assert img == len(blobs)
print(f"proc {pid}: {len(local_blobs)} images bit-exact; pod metrics ok",
      flush=True)
"""


@pytest.mark.skipif(os.environ.get("ROCJPEG_SKIP_MULTIPROC") == "1",
                    reason="multi-process test disabled")
def test_two_process_mesh_decode(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), "2", coord],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=root) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process decode timed out")
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "bit-exact" in out
