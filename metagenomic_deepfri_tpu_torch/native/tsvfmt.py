"""Rows of scores written as tab-separated text through ``tsvfmt.cpp``.

Each value is formatted as ``"%.9g" % float(value)`` formats it, byte for
byte, and no Python object is made per value: the rows are stacked into one
block a chunk, formatted into one byte buffer and written at once.
"""

from __future__ import annotations

from typing import BinaryIO, Sequence

import numpy as np

from metagenomic_deepfri_tpu_torch.native import build as native

# "%.9g" of a double is at most 16 bytes ("-1.23456789e-308"); and its tab.
_CELL_BYTES = 17
# Rows formatted per call of the library: a chunk's buffer stays near this.
CHUNK_BYTES = 32 << 20


def write_rows(fh: BinaryIO, prefixes: Sequence[str],
               rows: Sequence[np.ndarray]) -> int:
    """Write ``prefixes[i]``, the values of ``rows[i]`` joined by tabs and a
    newline for every row, to the binary file ``fh``; rows are of one
    length. float32 rows are read as they are, any other as float64.
    Returns the number of values written."""
    if len(prefixes) != len(rows):
        raise ValueError(f"{len(prefixes)} prefixes for {len(rows)} rows")
    if not rows:
        return 0
    lib = native.load("tsvfmt")
    cols = len(rows[0])
    step = max(1, CHUNK_BYTES // (cols * _CELL_BYTES + 1))
    buf = None
    for i in range(0, len(rows), step):
        block = np.asarray(rows[i:i + step])
        if block.ndim != 2 or block.shape[1] != cols:
            raise ValueError(f"rows of unequal lengths (the first has "
                             f"{cols} values)")
        if block.dtype == np.float32:
            fmt = lib.tsv_format_rows_f32
        else:
            block = block.astype(np.float64)
            fmt = lib.tsv_format_rows_f64
        block = np.ascontiguousarray(block)
        heads = [p.encode("utf-8") for p in prefixes[i:i + step]]
        offsets = np.zeros(len(heads) + 1, np.int64)
        np.cumsum([len(h) for h in heads], out=offsets[1:])
        cap = int(offsets[-1]) + len(heads) * (cols * _CELL_BYTES + 1)
        if buf is None or buf.size < cap:
            buf = np.empty(cap, np.uint8)
        n = fmt(block.ctypes.data, len(heads), cols, b"".join(heads),
                offsets.ctypes.data, buf.ctypes.data, cap)
        if n < 0:
            raise RuntimeError("tsv_format_rows: the buffer was too small")
        fh.write(memoryview(buf)[:n])
    return len(rows) * cols
