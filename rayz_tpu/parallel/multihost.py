"""Multi-host setup and per-host image assembly.

The reference is a single process (SURVEY.md §2: no threads, no processes, no
networking). The multi-host story here: ``jax.distributed.initialize``
joins the processes, the global 1-D mesh spans every device of the job, the
same ``render_sharded``/``make_train_step`` code runs SPMD on each host, and
``assemble_global_image`` materializes the full image on host 0 for writing.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .mesh import make_mesh

__all__ = ["initialize", "is_primary_host", "global_mesh", "assemble_global_image"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the multi-host job; call FIRST, before any other JAX API.

    With no arguments this defers to JAX's cluster auto-detection
    (``jax.distributed.initialize()`` reads a Slurm / Open MPI / cloud
    cluster environment where one exists); explicit arguments skip
    detection. A machine with no such environment needs the explicit
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``. Idempotent:
    returns silently if the distributed runtime is already up (e.g. the
    launcher initialized it). On a plain single-process environment with no
    detectable cluster, the no-arg form swallows JAX's "coordinator_address
    should be defined" error and proceeds single-process — explicit arguments
    never swallow errors.
    """
    from jax._src import distributed

    if distributed.global_state.client is not None:
        return  # already initialized — idempotent
    kw = {}
    if coordinator_address is not None:
        kw.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kw)
    except ValueError:
        # Auto-detection found no cluster (single-process run). An explicit
        # coordinator must not fail silently.
        if kw:
            raise


def is_primary_host() -> bool:
    return jax.process_index() == 0


def global_mesh():
    """1-D mesh over every device of the job (all hosts)."""
    return make_mesh(jax.devices())


def assemble_global_image(img) -> Optional[np.ndarray]:
    """Gather a (possibly sharded) device image to host 0 as numpy;
    returns None on other hosts."""
    from jax.experimental import multihost_utils

    if jax.process_count() > 1:
        # tiled=True: the input IS the global (sharded) array whose pieces
        # are gathered in place — tiled=False would stack a new leading
        # process axis and is rejected outright for non-fully-addressable
        # inputs (bug found by the real 2-process loopback test).
        img = multihost_utils.process_allgather(img, tiled=True)
        # process_allgather returns the full array on every host; only host 0
        # should write it.
        if not is_primary_host():
            return None
        return np.asarray(img)
    return np.asarray(img)
