"""A number the driver put in its record under ``spec["key"]``."""


def read(record: dict, spec: dict):
    return record.get(spec["key"])
