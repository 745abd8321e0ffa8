"""Share (%) of its roofline that a transformer trunk's attention core
reaches, whatever computes it.

The least time the window's attention needs (every batch, every layer:
``attention_bound_s`` of the module ``portbench.<spec["flops"]>``, from
the batch's ``tokens`` and ``attn_pairs``, the counters of its ``model/lm``
span) over the device seconds of the window's spans named by
``spec["span"]``. ``spec["trunk"]`` is the key of the trunk's widths in the
configuration (``"esmc"``). Nothing unless those spans number one a layer
and a batch: then they hold all of this work.
"""

import importlib

from portbench import flops, spans


def read(record: dict, spec: dict):
    chip = flops.peak(record.get("device_kind", ""))
    got = spans.windowed(record)
    if chip is None or got is None:
        return None
    arithmetic = importlib.import_module(f"portbench.{spec['flops']}")
    widths = record["config"][spec["trunk"]]
    lm = [s for s in got if s.name == "model/lm" and "tokens" in s.counts]
    sdpa = [s.device_s for s in got if s.name == spec["span"]]
    if not lm or len(sdpa) != len(lm) * widths["layers"] or None in sdpa:
        return None
    bound = widths["layers"] * sum(
        arithmetic.attention_bound_s(widths, s.counts["tokens"],
                                     s.counts["attn_pairs"], chip)
        for s in lm)
    return 100.0 * bound / sum(sdpa)
