"""Share (%) of its roofline that ProtT5's projections reach: E1's roofline
at ProtT5's shapes.

The GEMM work of the window's ``model/t5/gemm`` spans, read from their own
counters whatever computes them: Σ 2·``rows``·``k``·``n`` at the chip's
highest dense rate (the peak ``model_mfu.prott5`` divides by), over Σ device
seconds of those spans (the ReLU and residual add beside each product
included). Nothing unless the spans number four a layer and a batch: then
they hold all of this work.
"""

from portbench import flops, spans


def read(record: dict, spec: dict):
    chip = flops.peak(record.get("device_kind", ""))
    got = spans.windowed(record)
    if chip is None or got is None:
        return None
    layers = record["config"]["t5"]["layers"]
    lm = [s for s in got if s.name == "model/lm" and "tokens" in s.counts]
    gemm = [s for s in got if s.name == spec["span"]]
    if (not lm or len(gemm) != 4 * layers * len(lm)
            or any(s.device_s is None or "rows" not in s.counts
                   for s in gemm)):
        return None
    work = sum(2.0 * s.counts["rows"] * s.counts["k"] * s.counts["n"]
               for s in gemm)
    return 100.0 * work / chip["flops"] / sum(s.device_s for s in gemm)
