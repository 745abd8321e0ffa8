"""Share (%) of the chip's peak that the window's model work on a
configuration with a transformer trunk would fill.

The trunk's matmul FLOPs from the counters ``tokens`` and ``attn_pairs``
of the window's ``model/lm`` spans, the embedding merge and every mode's
tail at the length of each protein the window finished (``trunk_flops``,
``junction_flops`` and ``tails_flops`` of the module
``portbench.<spec["flops"]>``, the trunk's widths under the
configuration's key ``spec["trunk"]``), over the window's seconds times the
chip's highest dense rate. Nothing in an untraced run, or where the program
counts no tokens.
"""

import importlib

from portbench import flops, spans


def read(record: dict, spec: dict):
    chip = flops.peak(record.get("device_kind", ""))
    got = spans.windowed(record)
    if chip is None or got is None or not record.get("window_s"):
        return None
    lm = [s for s in got if s.name == "model/lm" and "tokens" in s.counts]
    if not lm:
        return None
    arithmetic = importlib.import_module(f"portbench.{spec['flops']}")
    config, modes = record["config"], record["modes"]
    total = arithmetic.trunk_flops(
        config[spec["trunk"]], sum(s.counts["tokens"] for s in lm),
        sum(s.counts["attn_pairs"] for s in lm))
    total += sum(arithmetic.junction_flops(config, int(n))
                 + arithmetic.tails_flops(config, int(n), modes)
                 for n in record.get("lengths", ()))
    return 100.0 * total / (record["window_s"] * chip["flops"])
