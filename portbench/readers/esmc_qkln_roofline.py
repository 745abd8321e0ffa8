"""Share (%) of its roofline that ESM C's q and k LayerNorms reach, with
rotary and q's scale: the work between the ``qkv`` projection and the
attention that no other trunk has.

The least time of each of the window's ``model/esmc/qkln`` spans
(``flops_esmc.qkln_bound_s`` of the span's own ``tokens`` counter, the real
tokens of its batch: q and k read and written once in float32), summed,
over Σ device seconds of those spans, whatever computes them. Nothing
unless those spans number one a layer and a batch and each counts its
tokens.
"""

from portbench import flops, flops_esmc, spans


def read(record: dict, spec: dict):
    chip = flops.peak(record.get("device_kind", ""))
    got = spans.windowed(record)
    if chip is None or got is None:
        return None
    esmc = record["config"]["esmc"]
    lm = [s for s in got if s.name == "model/lm" and "tokens" in s.counts]
    qkln = [s for s in got if s.name == spec["span"]]
    if (not lm or len(qkln) != len(lm) * esmc["layers"]
            or any(s.device_s is None or "tokens" not in s.counts
                   for s in qkln)):
        return None
    bound = sum(flops_esmc.qkln_bound_s(esmc, s.counts["tokens"], chip)
                for s in qkln)
    return 100.0 * bound / sum(s.device_s for s in qkln)
