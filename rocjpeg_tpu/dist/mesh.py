"""Device-mesh construction for multi-chip / multi-host decode.

The decode workload has two real parallel axes (SURVEY.md §2.4):

- ``data``: images in a batch (the analog of the reference's batch-
  parallelism across VCN JPEG cores, src/rocjpeg_decoder.cpp:208-218).
- ``space``: within-image rows of 8x8 blocks / restart segments (the
  analog of the restart-interval axis the reference forwards to hardware,
  src/rocjpeg_parser.cpp:374-390).

Collectives only arise at chroma/luma resharding seams and for metrics —
steady-state decode is embarrassingly parallel, so shardings are laid out
to keep everything lane-local.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None, space: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'space') mesh over the given (or all) devices.

    ``space`` devices shard within-image block rows; the rest shard the
    batch. space=1 (default) gives pure data parallelism, the right layout
    when batches are large.
    """
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n % space != 0:
        raise ValueError(f"{n} devices not divisible by space={space}")
    arr = np.array(devs).reshape(n // space, space)
    return Mesh(arr, ("data", "space"))
