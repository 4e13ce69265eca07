"""Multi-host runtime initialization and cross-host utilities.

The reference is single-process (SURVEY.md §2: no distribution of any
kind); multi-host scale-out is new design.  A multi-host deployment calls
`initialize()` once per host before building a mesh with
`parallel.mesh.make_mesh()`; utterance batches shard over the global 'data'
axis so each host feeds its local shard (`local_batch_slice`), and the only
cross-host traffic is the psum in `global_audio_seconds` style metric
reductions — the beam search itself is embarrassingly parallel per
utterance and needs the interconnect only for tensor-parallel AM
collectives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize wrapper; no-op when single-process.

    Pass the coordinator address (`host:port`), the number of processes
    and this process's id: a GPU cluster without a scheduler that JAX
    recognizes is not configured automatically.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """[start, stop) of this host's utterances in a globally sharded batch."""
    n = jax.process_count()
    idx = jax.process_index()
    per = global_batch // n
    extra = global_batch % n
    start = idx * per + min(idx, extra)
    stop = start + per + (1 if idx < extra else 0)
    return start, stop


def global_sum(x: float) -> float:
    """Sum a host-local scalar across all processes (metrics reduction)."""
    if jax.process_count() == 1:
        return float(x)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(
        np.asarray([x], np.float64))
    return float(np.sum(gathered))
