"""The port's tracing: stage timers, spans and counters, and the profiler
trace hook.

Counterpart of ``metagenomic_deepfri_tpu/profiling.py``:

- :func:`stage` — context manager timing a named pipeline stage on the
  host clock, with an optional item counter (→ items/s); results accumulate
  in a process-wide registry (:func:`report`, :func:`log_report`), always.
- :func:`span` / :func:`device_span` / :func:`count` — named intervals with
  counters, kept in an in-memory buffer only while recording is on
  (:func:`recording`): each records its name, id, the id of the enclosing
  span of the same thread (its parent), the thread, the batch it serves,
  start and end, and its counts; a device span also the device seconds
  between two CUDA events around its work. :func:`spans` returns them.
- :func:`torch_trace` — wraps ``torch.profiler.profile`` so a Chrome trace
  (host operators, CUDA kernels when a GPU is present, and the spans) is
  written when ``MDEEPFRI_TPU_TRACE_DIR`` is set (or a path is passed
  explicitly); a no-op otherwise. The counterpart of ``jax_trace``.

Recording is on while a ``torch.profiler`` session records (the flag
``torch.autograd.profiler._is_profiler_enabled`` that ``record_function``
reads) unless ``MDEEPFRI_TPU_SPANS`` or :func:`set_recording` says
otherwise (``1`` always, ``0`` never). When it is off, :func:`span` and
:func:`device_span` return one shared no-op context manager: a call site
costs a flag check, allocates no record and creates no CUDA event.

Timestamps are ``time.time_ns()``, the system clock on which the profiler
places its events (kineto's ``start_ns()``), so spans and the trace's
kernels and operators lie on one time line. A device span's CUDA events are
resolved to seconds only when :func:`spans` reads them, never on the path
that records them.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

logger = logging.getLogger(__name__)

_TRACE_ENV = "MDEEPFRI_TPU_TRACE_DIR"
_SPANS_ENV = "MDEEPFRI_TPU_SPANS"


@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    items: int = 0

    @property
    def items_per_sec(self) -> Optional[float]:
        return self.items / self.seconds if self.items and self.seconds else None


_REGISTRY: Dict[str, StageStats] = {}
# Guards the registry and the span buffer: stages and spans close on the
# pipeline's producer and consumer threads at once.
_LOCK = threading.Lock()


def _forced_from_env() -> Optional[bool]:
    value = os.environ.get(_SPANS_ENV, "").strip()
    return None if not value else value not in ("0", "off", "false")


_FORCED: Optional[bool] = _forced_from_env()


def set_recording(on: Optional[bool]) -> None:
    """Record spans always (True), never (False), or while a
    ``torch.profiler`` session records (None, the default unless
    ``MDEEPFRI_TPU_SPANS`` is set)."""
    global _FORCED
    _FORCED = on


def recording() -> bool:
    """Whether spans are being recorded."""
    if _FORCED is None:
        return _autograd_profiler._is_profiler_enabled
    return _FORCED


# -- spans ---------------------------------------------------------------------

@dataclass(eq=False)
class Span:
    """One recorded interval: ``start_ns``/``end_ns`` on the system clock
    (``time.time_ns()``), ``thread`` the native id of the thread that
    opened it (the profiler's ``tid``), ``parent`` the id of the enclosing
    span of that thread, ``batch`` the engine batch it serves (inherited
    from the parent), ``counts`` its counters. ``device_s`` is a device
    span's time: seconds between its CUDA events, or its host seconds when
    its device is not a CUDA one; None for a host span."""
    name: str
    id: int
    parent: Optional[int] = None
    thread: int = 0
    batch: Optional[int] = None
    start_ns: int = 0
    end_ns: int = 0
    counts: dict = field(default_factory=dict)
    device_s: Optional[float] = None
    on_device: bool = False
    _events: Optional[tuple] = field(default=None, repr=False)

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
            if self.batch is None:
                self.batch = stack[-1].batch
        stack.append(self)
        self.thread = threading.get_native_id()
        self.start_ns = time.time_ns()
        if self._events is not None:
            self._events[0].record(self._events[2])
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record(self._events[2])
        self.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        with _LOCK:
            _SPANS.append(self)

    def _resolve(self) -> None:
        """Device seconds from the CUDA events (waits for the second)."""
        if self._events is not None:
            start, end, _ = self._events
            end.synchronize()
            self.device_s = start.elapsed_time(end) / 1e3
            self._events = None
        elif self.on_device and self.device_s is None:
            self.device_s = self.host_s


class _NoSpan:
    """The shared no-op context manager of every call site while recording
    is off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()
_SPANS: List[Span] = []
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def span(name: str, batch: Optional[int] = None, **counts):
    """A host span named ``name`` while recording, else :data:`NO_SPAN`.
    ``batch`` is the engine batch's sequence number (children inherit it);
    ``counts`` its first counters (:func:`count` adds more)."""
    if not recording():
        return NO_SPAN
    return Span(name, next(_IDS), batch=batch, counts=counts)


def device_span(name: str, device):
    """A span of device work enqueued inside it, on ``device``: on a CUDA
    device a pair of timing events recorded on its current stream around the
    block (resolved by :func:`spans`); on any other device a host span whose
    host seconds are its device seconds (the work runs synchronously
    there). :data:`NO_SPAN` while not recording."""
    if not recording():
        return NO_SPAN
    rec = Span(name, next(_IDS), on_device=True)
    device = torch.device(device)
    if device.type == "cuda":
        rec._events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True),
                       torch.cuda.current_stream(device))
    return rec


def count(**counts) -> None:
    """Add ``counts`` to the innermost open span of this thread (nothing
    while not recording or outside any span)."""
    if not recording():
        return
    stack = _stack()
    if stack:
        got = stack[-1].counts
        for key, value in counts.items():
            got[key] = got.get(key, 0) + value


def spans() -> List[Span]:
    """The closed spans recorded since the last :func:`reset`, by start,
    with every device span's seconds resolved."""
    with _LOCK:
        out = list(_SPANS)
    for rec in out:
        rec._resolve()
    out.sort(key=lambda s: s.start_ns)
    return out


# -- stages ----------------------------------------------------------------------

def reset() -> None:
    """Clear the stage registry and the span buffer."""
    with _LOCK:
        _REGISTRY.clear()
        _SPANS.clear()


@contextlib.contextmanager
def stage(name: str, items: int = 0, log: bool = True):
    """Time a pipeline stage; optionally attribute an item count to it.
    While recording, the stage is also a span of the same name."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            st = _REGISTRY.setdefault(name, StageStats())
            st.calls += 1
            st.seconds += dt
            st.items += items
        if log:
            rate = f", {items / dt:.1f} items/s" if items and dt > 0 else ""
            logger.info("[profile] %s: %.3fs%s", name, dt, rate)


def add_items(name: str, items: int) -> None:
    """Attribute items to a stage after the fact (e.g. from callbacks)."""
    with _LOCK:
        _REGISTRY.setdefault(name, StageStats()).items += items


def report() -> Dict[str, dict]:
    """{stage: {calls, seconds, items, items_per_sec}}."""
    out = {}
    with _LOCK:
        stats = list(_REGISTRY.items())
    for name, st in stats:
        out[name] = {
            "calls": st.calls,
            "seconds": round(st.seconds, 4),
            "items": st.items,
            "items_per_sec": (round(st.items_per_sec, 2)
                              if st.items_per_sec else None),
        }
    return out


def _span_totals() -> Dict[str, dict]:
    """{span name: {calls, host_s, device_s (device spans), counts}} over
    :func:`spans`."""
    out: Dict[str, dict] = {}
    for rec in spans():
        row = out.setdefault(rec.name, {"calls": 0, "host_s": 0.0,
                                        "counts": {}})
        row["calls"] += 1
        row["host_s"] += rec.host_s
        if rec.device_s is not None:
            row["device_s"] = row.get("device_s", 0.0) + rec.device_s
        for key, value in rec.counts.items():
            row["counts"][key] = row["counts"].get(key, 0) + value
    return out


def log_report() -> None:
    """Log every stage's totals, then every span's that is not a stage."""
    stages = report()
    for name, row in stages.items():
        logger.info("[profile] total %-24s %6.2fs  calls=%d%s", name,
                    row["seconds"], row["calls"],
                    f"  {row['items_per_sec']} items/s"
                    if row["items_per_sec"] else "")
    for name, row in _span_totals().items():
        if name in stages:
            continue
        device = (f"  device {row['device_s']:.3f}s" if "device_s" in row
                  else "")
        counts = "".join(f"  {k}={v:.6g}" for k, v in row["counts"].items())
        logger.info("[profile] span  %-24s %6.2fs  calls=%d%s%s", name,
                    row["host_s"], row["calls"], device, counts)


# -- the profiler trace ------------------------------------------------------------

def _export_spans(path: Path, t0: int, t1: int) -> int:
    """Append the spans recorded in [t0, t1] to the Chrome trace at
    ``path`` as complete events on its own time base (``ts`` in µs after
    its ``baseTimeNanoseconds``), under this process and each span's
    thread; returns how many."""
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = []
    for rec in spans():
        if rec.start_ns < t0 or rec.end_ns > t1:
            continue
        args = {"id": rec.id, "parent": rec.parent, "batch": rec.batch,
                **rec.counts}
        if rec.device_s is not None:
            args["device_s"] = rec.device_s
        events.append({"ph": "X", "cat": "span", "name": rec.name,
                       "pid": pid, "tid": rec.thread,
                       "ts": (rec.start_ns - base) / 1e3,
                       "dur": (rec.end_ns - rec.start_ns) / 1e3,
                       "args": args})
    trace.setdefault("traceEvents", []).extend(events)
    path.write_text(json.dumps(trace))
    return len(events)


@contextlib.contextmanager
def torch_trace(trace_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace if a directory is configured.

    Directory precedence: explicit argument, then ``MDEEPFRI_TPU_TRACE_DIR``.
    Records CPU activity, and CUDA activity when a CUDA device is present,
    and writes ``torch_trace_<pid>_<ns>.json`` (Chrome trace format; open it
    in Perfetto or ``chrome://tracing``) into the directory on exit, also
    when the block raises (a server stopped by an interrupt); the spans
    recorded meanwhile are in it too.
    """
    trace_dir = trace_dir or os.environ.get(_TRACE_ENV)
    if not trace_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"torch_trace_{os.getpid()}_{time.time_ns()}.json"
    logger.info("Capturing torch profiler trace to %s", path)
    t0, prof = time.time_ns(), None
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        if prof is not None:
            t1 = time.time_ns()
            prof.export_chrome_trace(str(path))
            n = _export_spans(path, t0, t1)
            logger.info("Wrote the torch profiler trace, %d span(s), to %s",
                        n, path)
