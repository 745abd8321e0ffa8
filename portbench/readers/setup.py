"""Seconds from the process's start to the first timed item."""


def read(record: dict, spec: dict):
    return record.get("setup_s")
