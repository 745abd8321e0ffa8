"""Share (%) of the chip's peak that the window's model work on a
configuration with a ProtT5 encoder trunk would fill.

The encoder's matmul FLOPs from the counters ``tokens`` and ``attn_pairs``
of the window's ``model/lm`` spans (``flops_prott5.trunk_flops``), the
embedding merge and every mode's tail at the length of each protein the
window finished, over the window's seconds times the chip's highest dense
rate. Nothing in an untraced run, or where the program counts no tokens.
"""

from portbench import flops, flops_prott5, spans


def read(record: dict, spec: dict):
    chip = flops.peak(record.get("device_kind", ""))
    got = spans.windowed(record)
    if chip is None or got is None or not record.get("window_s"):
        return None
    lm = [s for s in got if s.name == "model/lm" and "tokens" in s.counts]
    if not lm:
        return None
    config, modes = record["config"], record["modes"]
    total = flops_prott5.trunk_flops(
        config["t5"], sum(s.counts["tokens"] for s in lm),
        sum(s.counts["attn_pairs"] for s in lm))
    total += sum(flops_prott5.junction_flops(config, int(n))
                 + flops_prott5.tails_flops(config, int(n), modes)
                 for n in record.get("lengths", ()))
    return 100.0 * total / (record["window_s"] * chip["flops"])
