"""Share (%) of its roofline that a transformer trunk's projections reach,
whatever computes them.

The GEMM work of the window's spans named by ``spec["span"]``, read from
their own counters: Σ 2·``rows``·``k``·``n`` (``n`` the columns the product
computes: 2F for a gated ``fc1``) at the chip's highest dense rate (the
peak the model's MFU divides by), over Σ device seconds of those spans (the
epilogue beside each product included). ``spec["trunk"]`` is the key of
the trunk's widths in the configuration (``"esmc"``), whose ``layers`` it
reads. Nothing unless the spans number four a layer and a batch: then they
hold all of this work.
"""

from portbench import flops, spans


def read(record: dict, spec: dict):
    chip = flops.peak(record.get("device_kind", ""))
    got = spans.windowed(record)
    if chip is None or got is None:
        return None
    layers = record["config"][spec["trunk"]]["layers"]
    lm = [s for s in got if s.name == "model/lm" and "tokens" in s.counts]
    gemm = [s for s in got if s.name == spec["span"]]
    if (not lm or len(gemm) != 4 * layers * len(lm)
            or any(s.device_s is None or "rows" not in s.counts
                   for s in gemm)):
        return None
    work = sum(2.0 * s.counts["rows"] * s.counts["k"] * s.counts["n"]
               for s in gemm)
    return 100.0 * work / chip["flops"] / sum(s.device_s for s in gemm)
