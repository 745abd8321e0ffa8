"""Items of the window over the window's seconds: ``spec["count"]`` names
the record's count (proteins, queries)."""


def read(record: dict, spec: dict):
    count = record.get(spec["count"])
    if not count or not record.get("window_s"):
        return None
    return count / record["window_s"]
