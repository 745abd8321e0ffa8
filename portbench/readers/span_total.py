"""Per 1,000 of the record's ``spec["per"]`` (proteins completed, queries),
the sum over the window's spans named ``spec["span"]`` of
``spec["value"]``: their host seconds (``host_s``), their device seconds
(``device_s``) or a counter's name. Nothing in an untraced run, or where no
such span carries the value."""

from portbench import spans


def read(record: dict, spec: dict):
    got = spans.windowed(record)
    per = record.get(spec["per"])
    if got is None or not per:
        return None
    values = [spans.value(s, spec["value"]) for s in got
              if s.name == spec["span"]]
    values = [v for v in values if v is not None]
    if not values:
        return None
    return 1000.0 * sum(values) / per
