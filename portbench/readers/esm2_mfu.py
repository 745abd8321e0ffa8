"""Share (%) of the chip's peak that the window's model work on a
configuration with an ESM-2 trunk would fill.

The trunk's matmul FLOPs from the counters ``tokens`` and ``attn_pairs``
of the window's ``model/lm`` spans (``flops_esm2.trunk_flops``), the
embedding merge and every mode's tail at the length of each protein the
window finished, over the window's seconds times the chip's highest dense
rate. Nothing in an untraced run, or where the program counts no tokens.
"""

from portbench import flops, flops_esm2, spans


def read(record: dict, spec: dict):
    chip = flops.peak(record.get("device_kind", ""))
    got = spans.windowed(record)
    if chip is None or got is None or not record.get("window_s"):
        return None
    lm = [s for s in got if s.name == "model/lm" and "tokens" in s.counts]
    if not lm:
        return None
    config, modes = record["config"], record["modes"]
    total = flops_esm2.trunk_flops(
        config["esm"], sum(s.counts["tokens"] for s in lm),
        sum(s.counts["attn_pairs"] for s in lm))
    total += sum(flops_esm2.junction_flops(config, int(n))
                 + flops_esm2.tails_flops(config, int(n), modes)
                 for n in record.get("lengths", ()))
    return 100.0 * total / (record["window_s"] * chip["flops"])
