"""Profiling: jax.profiler integration + lightweight timers.

The reference scatters ad-hoc timing through every layer (SURVEY.md §5);
here the stats dicts carry the same fields and this module adds the
device tracer: wrap any region in :func:`profile_trace` and open the dump
in TensorBoard/XProf to see per-op device time, or reduce it with
:func:`aggregate_xla_ops`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Tuple

__all__ = ["profile_trace", "Timer", "aggregate_xla_ops"]


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Capture a jax.profiler trace of the enclosed region into ``logdir``
    (open in TensorBoard/XProf for per-op device time)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def aggregate_xla_ops(logdir: str,
                      device=None) -> Tuple[Dict[str, int], int]:
    """Sum per-op device durations (ns) from a :func:`profile_trace` dump.

    Reads every ``*.xplane.pb`` under ``logdir`` and aggregates the "XLA
    Ops" line of each device plane of ``device``'s platform (planes named
    ``/device:GPU:<i>`` for a GPU; ``device`` defaults to
    ``jax.devices()[0]``) per op name — the programmatic equivalent of
    XProf's op table. Returns ``({op_name: total_ns}, n_events)``.

    Caveat: while/cond event durations include overlapped child waits —
    read leaf fusion/sort/gather lines, not loop events (see
    benchmarks/bench_step_profile.py for a worked decomposition).
    """
    import glob
    import os

    import jax

    device = device if device is not None else jax.devices()[0]
    prefix = f"/device:{device.platform.upper()}:"
    files = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                      recursive=True)
    if not files:
        raise RuntimeError(f"no xplane.pb under {logdir}")
    agg: Dict[str, int] = {}
    n_events = 0
    for f in files:
        pd = jax.profiler.ProfileData.from_file(f)
        for plane in pd.planes:
            if not plane.name.startswith(prefix):
                continue
            for line in plane.lines:
                if line.name != "XLA Ops":
                    continue
                for ev in line.events:
                    agg[ev.name] = agg.get(ev.name, 0) + ev.duration_ns
                    n_events += 1
    return agg, n_events


class Timer:
    """Accumulating named wall-clock timer for stats dicts."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def stats(self) -> Dict[str, dict]:
        return {
            name: {
                "total_seconds": self.totals[name],
                "count": self.counts[name],
                "avg_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }
