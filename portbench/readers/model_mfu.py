"""Share (%) of the chip's peak that the window's model work would fill.

The matmul FLOPs of every protein the window finished, at its own length
(GCN proteins: the shared trunk once, every mode's GraphConv stack, FC
stack and head; CNN proteins: every mode's convolutions, FC stack and
head), over the window's seconds times the chip's highest dense rate.
"""

from portbench import flops


def read(record: dict, spec: dict):
    chip = flops.peak(record.get("device_kind", ""))
    if chip is None or not record.get("window_s"):
        return None
    config, modes = record["config"], record["modes"]
    total = sum(flops.gcn_flops(config, int(n), modes)
                for n in record.get("lengths", ()))
    total += sum(flops.cnn_flops(config, int(n), modes)
                 for n in record.get("cnn_lengths", ()))
    if not total:
        return None
    return 100.0 * total / (record["window_s"] * chip["flops"])
