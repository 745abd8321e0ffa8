"""Share (%) of its roofline that ESM-2's attention core reaches.

The least time the window's attention needs (every batch, every layer:
``flops_esm2.attention_bound_s`` from the batch's ``tokens`` and
``attn_pairs``, the counters of its ``model/lm`` span) over the device
seconds of the window's ``model/esm/sdpa`` spans, whatever computes the
attention inside them. Nothing unless those spans number one a layer and
a batch: then they hold all of this work.
"""

from portbench import flops, flops_esm2, spans


def read(record: dict, spec: dict):
    chip = flops.peak(record.get("device_kind", ""))
    got = spans.windowed(record)
    if chip is None or got is None:
        return None
    esm = record["config"]["esm"]
    lm = [s for s in got if s.name == "model/lm" and "tokens" in s.counts]
    sdpa = [s.device_s for s in got if s.name == spec["span"]]
    if not lm or len(sdpa) != len(lm) * esm["layers"] or None in sdpa:
        return None
    bound = esm["layers"] * sum(
        flops_esm2.attention_bound_s(esm, s.counts["tokens"],
                                     s.counts["attn_pairs"], chip)
        for s in lm)
    return 100.0 * bound / sum(sdpa)
