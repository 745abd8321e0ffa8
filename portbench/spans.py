"""The program's spans inside a traced run's window.

The port records its spans (``metagenomic_deepfri_tpu_torch.profiling``)
while a ``torch.profiler`` session records, so a ``--trace 1`` run's window
holds them; their times are on the trace's clock (``time.time_ns()``), so
the window selects them. A program without spans gives nothing.
"""

from __future__ import annotations


def windowed(record: dict):
    """The spans that start and end inside the record's traced window, or
    None in an untraced run or for a program that records none."""
    tr = record.get("trace")
    if tr is None or not tr.traced:
        return None
    from metagenomic_deepfri_tpu_torch import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    w0, w1 = tr.window
    return [s for s in read() if s.start_ns >= w0 and s.end_ns <= w1]


def value(span, key: str):
    """``host_s``, ``device_s`` or the counter ``key`` of a span (None when
    it has none)."""
    if key == "host_s":
        return span.host_s
    if key == "device_s":
        return span.device_s
    return span.counts.get(key)
