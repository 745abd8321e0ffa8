"""The ``spec["q"]``-th percentile (linear between order statistics) of
the record's ``spec["key"]`` list, in which a failed item counts as
infinite; nothing when that makes it infinite (the run then has failed
items and is not correct)."""

import math

import numpy as np


def read(record: dict, spec: dict):
    values = record.get(spec["key"])
    if not values:
        return None
    p = float(np.percentile(np.asarray(values, np.float64), spec["q"]))
    return p if math.isfinite(p) else None
