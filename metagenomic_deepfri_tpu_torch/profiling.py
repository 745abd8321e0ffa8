"""Stage timers and throughput counters.

A copy of ``metagenomic_deepfri_tpu/profiling.py`` (``:31-100``):

- :func:`stage` — context manager timing a named pipeline stage on the
  host clock, with optional item counters (→ proteins/s) and edge counters
  (→ edges/s); results accumulate in a process-wide registry.
- :func:`report` / :func:`log_report` — structured summary of all stages.

The host clock is honest for the inference stages: the engine brings every
batch's scores to the host inside the stage. The JAX package's device-trace
hook (``jax_trace``) has no counterpart here yet.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass
from typing import Dict, Optional

logger = logging.getLogger(__name__)


@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    items: int = 0
    edges: int = 0

    @property
    def items_per_sec(self) -> Optional[float]:
        return self.items / self.seconds if self.items and self.seconds else None

    @property
    def edges_per_sec(self) -> Optional[float]:
        return self.edges / self.seconds if self.edges and self.seconds else None


_REGISTRY: Dict[str, StageStats] = {}


def reset() -> None:
    _REGISTRY.clear()


@contextlib.contextmanager
def stage(name: str, items: int = 0, edges: int = 0, log: bool = True):
    """Time a pipeline stage; optionally attribute item/edge counts to it."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        st = _REGISTRY.setdefault(name, StageStats())
        st.calls += 1
        st.seconds += dt
        st.items += items
        st.edges += edges
        if log:
            rate = f", {items / dt:.1f} items/s" if items and dt > 0 else ""
            logger.info("[profile] %s: %.3fs%s", name, dt, rate)


def add_items(name: str, items: int = 0, edges: int = 0) -> None:
    """Attribute counts to a stage after the fact (e.g. from callbacks)."""
    st = _REGISTRY.setdefault(name, StageStats())
    st.items += items
    st.edges += edges


def report() -> Dict[str, dict]:
    """{stage: {calls, seconds, items, items_per_sec, edges_per_sec}}."""
    out = {}
    for name, st in _REGISTRY.items():
        out[name] = {
            "calls": st.calls,
            "seconds": round(st.seconds, 4),
            "items": st.items,
            "items_per_sec": (round(st.items_per_sec, 2)
                              if st.items_per_sec else None),
            "edges_per_sec": (round(st.edges_per_sec, 2)
                              if st.edges_per_sec else None),
        }
    return out


def log_report() -> None:
    for name, row in report().items():
        logger.info("[profile] total %-24s %6.2fs  calls=%d%s", name,
                    row["seconds"], row["calls"],
                    f"  {row['items_per_sec']} items/s"
                    if row["items_per_sec"] else "")

