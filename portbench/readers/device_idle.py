"""Share (%) of the traced window in which nothing ran on the device: one
minus the union of kernel, copy and set intervals over the window."""


def read(record: dict, spec: dict):
    tr = record.get("trace")
    if tr is None or not tr.traced:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
