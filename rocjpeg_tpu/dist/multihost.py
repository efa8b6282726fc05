"""Multi-host utilities.

The reference has no distributed backend at all (SURVEY.md §5) — its
jpegDecodePerf partitions files across *threads* (jpegdecodeperf.cpp:245-252).
Lifted to hosts: each host runs its own input pipeline over its shard of
the corpus, decodes on its local devices via :class:`MeshDecoder` over the global
mesh, and only throughput metrics cross hosts (one psum at the end) — the
layout that makes scaling an input-pipeline problem, not a collective
problem.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize wrapper; no-op when single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def shard_files_for_host(paths: Sequence[str]) -> List[str]:
    """Per-host corpus shard (per-thread partitioning of
    jpegdecodeperf.cpp:245-252, lifted to processes)."""
    n = jax.process_count()
    i = jax.process_index()
    return list(paths)[i::n]


def allreduce_metrics(images: float, mpixels: float, seconds: float):
    """Sum decode metrics across hosts (the only steady-state collective)."""
    vals = np.array([images, mpixels, seconds], np.float64)
    if jax.process_count() == 1:
        return tuple(vals)
    from jax.experimental import multihost_utils
    summed = multihost_utils.process_allgather(vals).sum(axis=0)
    # seconds: use max (wall-clock), not sum
    gathered = multihost_utils.process_allgather(vals)
    return float(summed[0]), float(summed[1]), float(gathered[:, 2].max())
