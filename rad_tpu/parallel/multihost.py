"""Multi-host initialization for deployments across several machines.

Single-host multi-card needs nothing beyond :func:`rad_tpu.parallel.make_mesh`.
Across hosts, JAX's distributed runtime must be initialized before any mesh
is built; this wraps ``jax.distributed.initialize`` and builds the global
mesh over all connected processes' devices. The graph-sharded kernels
(rad_tpu.parallel.sharded) work unchanged: per-step collectives ride NVLink
within a host and the network across hosts, and the coordination/HTTP
layer (rad_tpu.server) remains the scoring-worker fan-out channel exactly
as in single-host mode.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["initialize_multihost", "global_mesh"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (idempotent). Arguments left None are
    discovered only from a cluster environment JAX recognises (such as
    SLURM); elsewhere pass ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id`` explicitly."""
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        logger.info("jax.distributed initialized: process %d/%d",
                    jax.process_index(), jax.process_count())
    except RuntimeError as e:
        if "already" in str(e).lower():
            logger.debug("jax.distributed already initialized")
        else:
            raise


def global_mesh(axis_names: Sequence[str] = ("graph",)):
    """A mesh over every device of every connected process."""
    import jax

    from rad_tpu.parallel.mesh import make_mesh

    return make_mesh(len(jax.devices()), axis_names=axis_names)
