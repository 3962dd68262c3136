"""Device mesh construction for graph-sharded screening.

The reference scales by adding scoring workers against one shared Redis
(README.md:120-129) — the library itself never shards. Here the *graph* is
the partitioned dimension (SURVEY.md §5 long-axis mapping): fingerprints and
adjacency rows are sharded across cards over NVLink, while the (small) frontier
and counters are replicated, so a 2B×128B fingerprint matrix (256 GB) spreads
across the cards of a host.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh"]


def make_mesh(n_devices: int | None = None,
              axis_names: Sequence[str] = ("graph",),
              devices=None) -> Mesh:
    """A 1-D (default) or N-D mesh over the first ``n_devices`` devices.

    With one axis name the mesh is 1-D over the graph axis; pass two names
    (e.g. ``("data", "graph")``) with ``n_devices`` a tuple to get a 2-D
    mesh for batched-query × sharded-graph search.
    """
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
        if shape is None:
            raise ValueError("give n_devices as a tuple for N-D meshes")
    elif isinstance(n_devices, int):
        if len(axis_names) != 1:
            raise ValueError("int n_devices requires a single axis name")
        shape = (n_devices,)
    else:
        shape = tuple(n_devices)
    total = int(np.prod(shape))
    if total > len(devs):
        raise ValueError(f"need {total} devices, have {len(devs)}")
    grid = np.array(devs[:total]).reshape(shape)
    return Mesh(grid, axis_names=tuple(axis_names))
