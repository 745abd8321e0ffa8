"""The device trace of a ``--trace 1`` run.

The measured window runs inside one ``torch.profiler`` session that
records the device's activity alone (kernels, copies, sets): recording
every host operator as well slowed the launch-bound LSTM-LM by a third on
the H100 and so inflated the idle share it was meant to read. What the
host was doing comes instead from a sampling thread that reads the Python
stack of the thread that drives the device every 50 ms: each read takes
the interpreter lock from a feed that is bound by the host, so reads are
kept few enough to cost nothing measurable (and still name gaps of a
batch's packing, some 50-80 ms each).

From the events: the seconds in which anything ran on the device (the
union of its intervals inside the window), the device time and count of
kernels by name, the operations that took the most device time, and the
longest idle gaps, each named by the host code that the samples inside it
saw most often. Host and device times are both on the profiler's clock
(nanoseconds of the system clock).
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

_TOP = 10
_NAME_CHARS = 160
_SAMPLE_S = 0.05
# Frames of these files are skipped when naming what the host did: the
# code of interest is the program's or the benchmark's own.
_LIBRARY_PARTS = (os.sep + "torch" + os.sep, os.sep + "threading.py",
                  os.sep + "contextlib.py")


def _describe(frame) -> str:
    """``file.py:function`` of the innermost frame outside the libraries,
    with the innermost library frame after a ``>`` when there is one."""
    inner = None
    while frame is not None:
        path = frame.f_code.co_filename
        where = f"{os.path.basename(path)}:{frame.f_code.co_name}"
        if not any(p in path for p in _LIBRARY_PARTS):
            return where if inner is None else f"{where} > {inner}"
        inner = inner or where
        frame = frame.f_back
    return inner or "idle"


class _Sampler(threading.Thread):
    """Samples one thread's Python stack until stopped."""

    def __init__(self, ident: int):
        super().__init__(daemon=True, name="portbench-sampler")
        self.target, self.samples = ident, []
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.wait(_SAMPLE_S):
            frames = sys._current_frames()
            self.samples.append((time.time_ns(),
                                 _describe(frames.get(self.target))))
            # A frame held past its return keeps its tensors alive.
            del frames

    def stop(self) -> None:
        self._halt.set()
        self.join()


class DeviceTrace:
    """Device events and host samples of one traced window."""

    def __init__(self):
        self.dev_start = self.dev_end = np.zeros(0, np.int64)
        self.dev_name: list = []
        self.samples: list = []
        self.window = None

    @contextlib.contextmanager
    def record(self, enabled: bool, device, thread: int | None = None):
        """Trace the block when ``enabled``; the block is the window. Off a
        CUDA ``device`` there is no device activity to record. ``thread``
        (an ident) is the thread whose stack names the idle gaps: the
        calling one unless the device work runs on another."""
        if not enabled:
            yield
            return
        cuda = torch.device(device).type == "cuda"
        sampler = _Sampler(thread or threading.get_ident())
        with profile(activities=[ProfilerActivity.CUDA] if cuda
                     else [ProfilerActivity.CPU]) as prof:
            sampler.start()
            w0 = time.time_ns()
            try:
                yield
                if cuda:
                    torch.cuda.synchronize()
            finally:
                w1 = time.time_ns()
                sampler.stop()
        self.window = (w0, w1)
        self.samples = sampler.samples
        if cuda:
            self._read(prof.profiler.kineto_results.events())

    def _read(self, events) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        ds, de, dn = [], [], []
        for e in events:
            if e.device_type() != cuda or e.is_user_annotation():
                continue
            s = e.start_ns()
            ds.append(s)
            de.append(s + e.duration_ns())
            dn.append(e.name())
        order = np.argsort(np.asarray(ds, np.int64), kind="stable")
        self.dev_start = np.asarray(ds, np.int64)[order]
        self.dev_end = np.asarray(de, np.int64)[order]
        self.dev_name = [dn[i] for i in order]

    @property
    def traced(self) -> bool:
        return self.window is not None

    def _merged(self):
        """Disjoint busy intervals of the device inside the window."""
        if not len(self.dev_start):
            return np.zeros((0, 2), np.int64)
        w0, w1 = self.window
        s = np.clip(self.dev_start, w0, w1)
        e = np.clip(self.dev_end, w0, w1)
        run_end = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        starts = s[new]
        ends = np.append(run_end[np.nonzero(new)[0][1:] - 1], run_end[-1])
        keep = ends > starts
        return np.stack([starts[keep], ends[keep]], axis=1)

    def busy_s(self) -> float:
        m = self._merged()
        return float((m[:, 1] - m[:, 0]).sum()) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernel_time(self, names) -> tuple:
        """(launches, device seconds) of the kernels whose name contains
        one of ``names``."""
        hit = np.array([any(n in k for n in names) for k in self.dev_name],
                       bool)
        if not hit.any():
            return 0, 0.0
        dur = (self.dev_end - self.dev_start)[hit]
        return int(hit.sum()), float(dur.sum()) / 1e9

    def device_ops(self) -> list:
        """[[name, seconds]] of the operations with the most device time."""
        total: dict = {}
        for name, d in zip(self.dev_name,
                           (self.dev_end - self.dev_start).tolist()):
            total[name] = total.get(name, 0) + d
        top = sorted(total.items(), key=lambda kv: -kv[1])[:_TOP]
        return [[n[:_NAME_CHARS], d / 1e9] for n, d in top]

    def idle_gaps(self) -> list:
        """[[host code, seconds]] of the longest idle gaps inside the
        window (before the first, between, and after the last device
        operation), each named by the host sample seen most often in it
        (the one nearest its middle when it holds none)."""
        m = self._merged()
        w0, w1 = self.window
        edges = np.concatenate([[w0], m.ravel(), [w1]]).reshape(-1, 2)
        lengths = edges[:, 1] - edges[:, 0]
        times = np.asarray([t for t, _ in self.samples], np.int64)
        out = []
        for i in np.argsort(-lengths, kind="stable")[:_TOP]:
            if lengths[i] <= 0:
                break
            lo, hi = np.searchsorted(times, edges[i])
            names = [self.samples[k][1] for k in range(lo, hi)]
            if not names and len(times):
                mid = (edges[i, 0] + edges[i, 1]) // 2
                names = [self.samples[int(np.argmin(np.abs(times - mid)))][1]]
            name = (collections.Counter(names).most_common(1)[0][0]
                    if names else "no sample")
            out.append([name[:_NAME_CHARS], float(lengths[i]) / 1e9])
        return out
