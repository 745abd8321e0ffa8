"""The TSV row formatter of the prediction matrices (``native/tsvfmt.cpp``).

Its rows are held byte for byte to what the pipeline wrote before it:
``np.char.mod("%.9g", row.astype(np.float64))`` joined by tabs, after the
row's prefix, with a newline.
"""

import io

import numpy as np
import pytest

from metagenomic_deepfri_tpu_torch.native import tsvfmt

F32 = np.finfo(np.float32)


def printf_rows(prefixes, rows) -> bytes:
    """The rows as ``np.char.mod("%.9g")`` formats them."""
    return "".join(
        p + "\t".join(np.char.mod(
            "%.9g", np.asarray(r, dtype=np.float64)).tolist()) + "\n"
        for p, r in zip(prefixes, rows)).encode("utf-8")


def native_rows(prefixes, rows) -> bytes:
    fh = io.BytesIO()
    cells = tsvfmt.write_rows(fh, prefixes, rows)
    assert cells == sum(len(r) for r in rows)
    return fh.getvalue()


def _specials():
    nan = np.float32(np.nan)
    return np.array([0.0, -0.0, 1.0, np.float32(0.1), np.float32(1e-45),
                     F32.tiny, F32.max, -F32.max, nan, np.negative(nan),
                     np.inf, -np.inf, F32.smallest_subnormal, 0.5, 1e-30,
                     np.float32(1 / 3), 123456789.0, 1e9, 1e10],
                    dtype=np.float32)


def _next_to_powers_of_ten():
    out = []
    for k in range(-10, 1):
        v = np.float32(10.0 ** k)
        out += [np.nextafter(v, np.float32(0)), v,
                np.nextafter(v, np.float32(np.inf))]
    return np.array(out, dtype=np.float32)


VALUES = {
    "uniform": lambda rng: rng.random((40, 489), dtype=np.float32),
    "exp_uniform": lambda rng: np.exp(
        rng.uniform(-100, 0, (40, 320))).astype(np.float32),
    "specials": lambda rng: np.stack([_specials(), _specials()[::-1]]),
    "powers_of_ten": lambda rng: _next_to_powers_of_ten()[None, :],
}


@pytest.mark.parametrize("kind", sorted(VALUES))
def test_rows_byte_equal_to_printf(kind):
    """Seeded float32 rows: every byte as ``"%.9g"`` gives it, NaN with its
    sign bit set included (Python writes "nan")."""
    block = VALUES[kind](np.random.default_rng(17))
    prefixes = [f"q{i}\t{'gcn' if i % 2 else 'cnn'}\t"
                for i in range(len(block))]
    rows = list(block)
    assert native_rows(prefixes, rows) == printf_rows(prefixes, rows)


@pytest.mark.parametrize("cols", [0, 1, 3992])
def test_row_lengths(cols):
    """An empty row, one term, and bp's 3,992 terms."""
    rng = np.random.default_rng(cols)
    rows = list(rng.random((5, cols), dtype=np.float32))
    prefixes = [f"protein_{i}\tgcn\t" for i in range(5)]
    assert native_rows(prefixes, rows) == printf_rows(prefixes, rows)


def test_float64_rows_keep_their_precision():
    """Rows that are not float32 are formatted from float64, as the old
    formatter did, not rounded to float32 first."""
    rows = [np.array([0.1, 1 / 3, 2.0 ** -1074, 1e300, -1.7976931348623157e308,
                      1.23456789012345e-300]),
            [0.25, 1e-5, 7.0, 1.0000000001, np.nan, -np.inf]]
    prefixes = ["a\tgcn\t", "b\tcnn\t"]
    assert native_rows(prefixes, rows) == printf_rows(prefixes, rows)


def test_chunks_and_unicode_prefixes(monkeypatch):
    """Rows split over several calls of the library, and non-ASCII ids,
    give the same bytes as one pass."""
    monkeypatch.setattr(tsvfmt, "CHUNK_BYTES", 5000)
    rng = np.random.default_rng(3)
    rows = list(rng.random((23, 97), dtype=np.float32))
    prefixes = [f"protéine_{i}–x\tgcn\t" for i in range(23)]
    assert native_rows(prefixes, rows) == printf_rows(prefixes, rows)


def test_no_rows_writes_nothing():
    fh = io.BytesIO()
    assert tsvfmt.write_rows(fh, [], []) == 0
    assert fh.getvalue() == b""


def test_rows_of_unequal_lengths_raise():
    with pytest.raises(ValueError):
        tsvfmt.write_rows(io.BytesIO(), ["a\t", "b\t"],
                          [np.zeros(3, np.float32), np.zeros(4, np.float32)])
    with pytest.raises(ValueError, match="prefixes"):
        tsvfmt.write_rows(io.BytesIO(), ["a\t"], [])
