"""100 × (1 − Σ ``spec["part"]`` / Σ ``spec["whole"]``), both counters of
the window's spans named ``spec["span"]``: the share (%) of the whole that
the part leaves, such as the padded share of the engine's batch slots.
Nothing in an untraced run or where the whole sums to 0."""

from portbench import spans


def read(record: dict, spec: dict):
    got = spans.windowed(record)
    if got is None:
        return None
    mine = [s for s in got if s.name == spec["span"]]
    whole = sum(s.counts.get(spec["whole"], 0) for s in mine)
    if not whole:
        return None
    part = sum(s.counts.get(spec["part"], 0) for s in mine)
    return 100.0 * (1.0 - part / whole)
