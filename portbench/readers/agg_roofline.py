"""Share (%) of its roofline that the GraphConv aggregation Â·X reaches.

The least time the window's aggregations need (every batch, every mode,
every GraphConv layer: ``flops.aggregation_bound_s`` at the batch's real
lengths and the layer's input width) over the device time of the kernels
named in the metric's file. Nothing is read unless those kernels ran
exactly once a layer, a mode and a batch: then they did all of this work
and nothing else.
"""

from portbench import flops


def read(record: dict, spec: dict):
    tr = record.get("trace")
    chip = flops.peak(record.get("device_kind", ""))
    if tr is None or chip is None:
        return None
    launches, seconds = tr.kernel_time(spec["kernels"])
    config, modes, batches = record["config"], record["modes"], \
        record["batches"]
    widths = [config["embed_dim"]] + list(config["gc_dims"][:-1])
    if not launches or launches != len(batches) * len(widths) * len(modes):
        return None
    bound = len(modes) * sum(
        flops.aggregation_bound_s(sum_n, sum_n2, B, D, chip)
        for B, sum_n, sum_n2 in batches for D in widths)
    return 100.0 * bound / seconds
