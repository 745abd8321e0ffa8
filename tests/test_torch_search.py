"""The port's alignment and search layer against the JAX package's.

Exact unless a tolerance is stated: Needleman–Wunsch scores and alignment
strings, the built-in k-mer search's rows, ``SearchResults`` filters and
files, database building, coordinate extraction from a structure directory,
and the re-alignment of search hits. ``torch`` is imported here on purpose:
the native libraries link the system OpenMP runtime, and torch loads its own,
so the multithreaded calls below run with both in one process.
"""

import gzip
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch  # noqa: F401  (its OpenMP runtime next to the native libraries)

from metagenomic_deepfri_tpu.align import matrices as jax_matrices
from metagenomic_deepfri_tpu.align import pairwise as jax_pairwise
from metagenomic_deepfri_tpu.data.structures import write_ca_pdb
from metagenomic_deepfri_tpu.ops import nw as jax_nw
from metagenomic_deepfri_tpu.search import database as jax_database
from metagenomic_deepfri_tpu.search import engine as jax_engine
from metagenomic_deepfri_tpu.search import pdb as jax_pdb
from metagenomic_deepfri_tpu.search.results import \
    SearchResults as JaxSearchResults
from metagenomic_deepfri_tpu_torch.align import matrices, pairwise
from metagenomic_deepfri_tpu_torch.native import build as native
from metagenomic_deepfri_tpu_torch.ops import nw
from metagenomic_deepfri_tpu_torch.search import database, engine, pdb
from metagenomic_deepfri_tpu_torch.search.results import SearchResults

AAS = list("ACDEFGHIKLMNPQRSTVWY")
REPO = Path(__file__).resolve().parent.parent


def _random_seq(rng, n):
    return "".join(rng.choice(AAS, size=n))


def _mutate(rng, seq, rate):
    out = list(seq)
    for pos in rng.choice(len(seq), size=int(round(rate * len(seq))),
                          replace=False):
        out[pos] = rng.choice([a for a in AAS if a != out[pos]])
    return "".join(out)


def _matrix_file(path: Path) -> Path:
    """BLOSUM62 with every diagonal entry raised by 2 and "X" scored -2,
    written in NCBI format: a matrix the code has not seen by name."""
    sm = matrices.ScoringMatrix.from_name("BLOSUM62")
    m = sm.matrix.copy()
    m[np.diag_indices_from(m)] += 2
    x = sm.alphabet.index("X")
    m[x, :] = m[:, x] = -2
    lines = ["# test matrix", "   " + "  ".join(sm.alphabet)]
    lines += [f"{a} " + " ".join(f"{v:3d}" for v in row)
              for a, row in zip(sm.alphabet, m)]
    path.write_text("\n".join(lines) + "\n")
    return path


def _scorings(kind, tmp_path):
    if kind == "BLOSUM62":
        return (matrices.ScoringMatrix.from_name("BLOSUM62"),
                jax_matrices.ScoringMatrix.from_name("BLOSUM62"))
    path = _matrix_file(tmp_path / "TESTMAT.out")
    return (matrices.ScoringMatrix.from_file(path),
            jax_matrices.ScoringMatrix.from_file(path))


@pytest.mark.parametrize("kind", ["BLOSUM62", "file"])
def test_nw_matches_jax_and_python(kind, tmp_path):
    """100 seeded pairs per matrix (lengths 1–300, some near-copies, three
    gap settings): the native NW equals the JAX package's (score and
    alignment string), its score equals the numpy oracle's, and
    ``nw_score_many`` (4 threads) equals both packages' single scores."""
    ours, theirs = _scorings(kind, tmp_path)
    assert np.array_equal(ours.matrix, theirs.matrix)
    assert ours.alphabet == theirs.alphabet
    rng = np.random.default_rng(1 if kind == "BLOSUM62" else 2)
    gaps = [(10, 1), (11, 1), (5, 2)]
    pairs = []
    for i in range(100):
        q = _random_seq(rng, int(rng.integers(1, 301)))
        t = (_mutate(rng, q, 0.2) if i % 3 == 0
             else _random_seq(rng, int(rng.integers(1, 301))))
        pairs.append((q, t, gaps[i % 3]))
    for q, t, (go, ge) in pairs:
        score, aln = nw.nw_align(q, t, ours, go, ge)
        assert (score, aln) == jax_nw.nw_align(q, t, theirs, go, ge)
        py_score, py_aln = nw.nw_align(q, t, ours, go, ge, force_python=True)
        assert py_score == score
        assert py_aln.count("M") + py_aln.count("D") == len(q)
        assert nw.alignment_stats(q, t, aln) == \
            jax_nw.alignment_stats(q, t, aln)
    for go, ge in gaps:
        q = pairs[0][0]
        targets = [t for _, t, _ in pairs]
        many = nw.nw_score_many(q, targets, ours, go, ge, threads=4)
        assert many.dtype == np.int32
        assert np.array_equal(
            many, jax_nw.nw_score_many(q, targets, theirs, go, ge,
                                       threads=4))
        assert np.array_equal(many, [nw.nw_align(q, t, ours, go, ge)[0]
                                     for t in targets])
    assert np.array_equal(
        nw.nw_score_many(pairs[1][0], [t for _, t, _ in pairs[:12]], ours,
                         force_python=True),
        nw.nw_score_many(pairs[1][0], [t for _, t, _ in pairs[:12]], ours))


def test_scoring_matrix_resolution_matches_jax(caplog):
    """Neither package bundles VTML80: "auto" resolves to BLOSUM62 in both,
    with the one-time warning; unknown names are errors in both."""
    import logging

    caplog.set_level(logging.WARNING)
    ours = matrices.resolve_scoring_matrix("auto")
    theirs = jax_matrices.resolve_scoring_matrix("auto")
    assert ours.name == theirs.name == "BLOSUM62"
    assert np.array_equal(ours.matrix, theirs.matrix)
    for mod in (matrices, jax_matrices):
        with pytest.raises(ValueError, match="not available"):
            mod.ScoringMatrix.from_name("NO_SUCH_MATRIX")


@pytest.fixture(scope="module")
def homology_set():
    """The 200-target set of ``tests/test_search_recall.py``: queries
    point-mutated at 5–65 % and random decoys."""
    rng = np.random.default_rng(42)
    targets = {f"t{i}": _random_seq(rng, int(rng.integers(80, 300)))
               for i in range(200)}
    t_ids = list(targets)
    queries = {}
    for rate in (0.05, 0.15, 0.25, 0.35, 0.45, 0.55, 0.65):
        for _ in range(10):
            tid = t_ids[int(rng.integers(len(t_ids)))]
            queries[f"q{len(queries)}"] = _mutate(rng, targets[tid], rate)
    for _ in range(20):
        queries[f"q{len(queries)}"] = _random_seq(
            rng, int(rng.integers(80, 300)))
    return targets, queries


def _tables_equal(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and all(np.array_equal(a[c], b[c]) for c in a.dtype.names))


def test_builtin_search_matches_jax(homology_set):
    targets, queries = homology_set
    kw = dict(max_eval=1e-3, threads=4, query_fasta="q.faa",
              database="db.fasta")
    ours = engine.builtin_search(queries, targets, **kw)
    theirs = jax_engine.builtin_search(queries, targets, **kw)
    assert len(ours) > 40
    assert _tables_equal(ours.table, theirs.table)
    assert (ours.query_fasta, ours.database) == \
        (theirs.query_fasta, theirs.database)


def test_search_results_filters_and_files_cross_load(homology_set, tmp_path):
    targets, queries = homology_set
    rows = engine.builtin_search(queries, targets, max_eval=10.0, threads=2,
                                 query_fasta="q.faa", database="db.fasta")
    theirs = JaxSearchResults(rows.table.copy(), rows.query_fasta,
                              rows.database)
    for kw in (dict(min_cov=0.9, min_ident=0.5),
               dict(min_cov=0.5, min_bits=40.0), {}):
        f_ours = rows.apply_filters(**kw)
        f_theirs = theirs.apply_filters(**kw)
        assert _tables_equal(f_ours.table, f_theirs.table)
        for k in (1, 2, 5):
            assert _tables_equal(f_ours.find_best_matches(k).table,
                                 f_theirs.find_best_matches(k).table)
    assert rows.targets_by_query().keys() == theirs.targets_by_query().keys()

    best = rows.find_best_matches(3)
    for ext in ("tsv", "npz"):
        mine, jaxs = tmp_path / f"ours.{ext}", tmp_path / f"jax.{ext}"
        best.save(mine, filetype=ext)
        JaxSearchResults(best.table, best.query_fasta,
                         best.database).save(jaxs, filetype=ext)
        if ext == "tsv":
            assert mine.read_bytes() == jaxs.read_bytes()
        for loaded in (SearchResults.load(jaxs), JaxSearchResults.load(mine)):
            assert _tables_equal(loaded.table, best.table)
            assert (loaded.query_fasta, loaded.database) == \
                ("q.faa", "db.fasta")


def _structure_db(root: Path, n: int = 6, seed: int = 5):
    rng = np.random.default_rng(seed)
    structures = root / "structures"
    structures.mkdir(parents=True)
    seqs = {}
    for i in range(n):
        seqs[f"af_{i}"] = _random_seq(rng, 60 + 7 * i)
        steps = rng.normal(size=(len(seqs[f"af_{i}"]), 3))
        steps /= np.linalg.norm(steps, axis=1, keepdims=True)
        write_ca_pdb(structures / f"af_{i}.pdb", seqs[f"af_{i}"],
                     np.cumsum(3.8 * steps, axis=0).astype(np.float32))
    (structures / "notes.txt").write_text("not a structure\n")
    (root / "targets.fasta").write_text(
        "".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    with gzip.open(root / "targets_gz.fasta.gz", "wt") as f:
        f.write("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    return root, seqs


def _gunzip_text(path: Path) -> str:
    with gzip.open(path, "rt") as f:
        return f.read()


@pytest.mark.parametrize("source", ["targets.fasta", "targets_gz.fasta.gz",
                                    "structures"])
def test_build_database_matches_jax(source, tmp_path):
    """A FASTA file, a gzipped FASTA and a structure directory: the same
    Database (names relative to each package's copy) and the same
    sequences."""
    fixture, seqs = _structure_db(tmp_path / "fixture")
    dbs = {}
    for name, mod in (("torch", database), ("jax", jax_database)):
        root = tmp_path / name
        shutil.copytree(fixture, root)
        dbs[name] = (root, mod.build_database(root / source, root))
    (ours_root, ours), (jax_root, theirs) = dbs["torch"], dbs["jax"]
    for field in ("foldcomp_db", "sequence_db", "mmseqs_db"):
        assert Path(getattr(ours, field)).relative_to(ours_root) == \
            Path(getattr(theirs, field)).relative_to(jax_root)
    assert ours.name == theirs.name
    text = _gunzip_text(Path(ours.sequence_db))
    assert text == _gunzip_text(Path(theirs.sequence_db))
    assert text == "".join(f">{k}\n{v}\n" for k, v in seqs.items())
    # a second build reuses the sequence DB
    again = database.build_database(ours_root / source, ours_root)
    assert again.sequence_db == ours.sequence_db


def test_extract_calpha_coords_structure_dir(tmp_path):
    fixture, seqs = _structure_db(tmp_path / "fixture")
    db = database.build_database(fixture / "structures", fixture)
    jdb = jax_database.build_database(fixture / "structures", fixture)
    tids = ["af_3", "af_0", "missing", "af_5"]
    qids = ["q0", "q1", "q2", "q3"]
    saved = {}
    coords = {}
    for name, mod, d in (("torch", pdb, db), ("jax", jax_pdb, jdb)):
        saved[name] = tmp_path / f"saved_{name}"
        saved[name].mkdir()
        with pytest.warns(UserWarning, match="missing"):
            coords[name] = mod.extract_calpha_coords(
                d, tids, qids, save_directory=saved[name], threads=2)
    assert coords["torch"][2] is None and coords["jax"][2] is None
    for tid, ours, theirs in zip(tids, coords["torch"], coords["jax"]):
        if tid == "missing":
            continue
        assert ours.shape == (len(seqs[tid]), 3) and ours.dtype == np.float32
        assert np.array_equal(ours, theirs)
    names = sorted(p.name for p in saved["torch"].iterdir())
    assert names == ["af_0.pdb", "af_3.pdb", "af_5.pdb"]
    for n in names:
        assert (saved["torch"] / n).read_bytes() == \
            (saved["jax"] / n).read_bytes()


def test_align_mmseqs_results_matches_jax(homology_set, tmp_path):
    """Search hits re-aligned against a gzipped sequence DB: the same
    AlignmentResult fields, in the same order, from both packages."""
    targets, queries = homology_set
    seq_db = tmp_path / "targets.fasta.gz"
    with gzip.open(seq_db, "wt") as f:
        f.write("".join(f">{k}\n{v}\n" for k, v in targets.items()))
    query_fasta = tmp_path / "queries.faa"
    query_fasta.write_text("".join(f">{k}\n{v}\n" for k, v in queries.items()))
    best = engine.builtin_search(queries, targets, max_eval=1e-3, threads=2,
                                 query_fasta=str(query_fasta),
                                 database=str(seq_db)).find_best_matches(3)
    best.save(tmp_path / "best.tsv")
    kw = dict(alignment_gap_open=10, alignment_gap_extend=1, threads=4,
              scoring_matrix="BLOSUM62")
    ours = pairwise.align_mmseqs_results(tmp_path / "best.tsv", seq_db, **kw)
    theirs = jax_pairwise.align_mmseqs_results(tmp_path / "best.tsv", seq_db,
                                               **kw)
    fields = ("query_name", "query_sequence", "target_name",
              "target_sequence", "alignment", "query_identity",
              "query_coverage", "target_coverage", "gapped_sequence",
              "gapped_target")
    assert len(ours) == len(theirs) > 40
    for a, b in zip(ours, theirs):
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields]
    one = pairwise.pairwise_against_database(
        "q0", queries["q0"], dict(list(targets.items())[:50]))
    other = jax_pairwise.pairwise_against_database(
        "q0", queries["q0"], dict(list(targets.items())[:50]))
    assert [getattr(one, f) for f in fields] == \
        [getattr(other, f) for f in fields]


def test_native_libraries_built_in_port_build_dir():
    """Both libraries come from the JAX package's sources, are written into
    the port's own build directory under a key of source, compiler, flags
    and CPU, and never next to the sources."""
    for name in native.NAMES:
        path = native.library_path(name)
        assert path.parent == REPO / "metagenomic_deepfri_tpu_torch" / "build"
        assert native.source_path(name) == \
            REPO / "metagenomic_deepfri_tpu" / "native" / f"{name}.cpp"
        assert native.load(name) is native.load(name)
        assert path.is_file()


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A compiler that fails (a fake ``g++`` first on ``PATH``) or is
    missing raises NativeBuildError with its output; nothing falls back to
    the numpy NW."""
    fake_bin = tmp_path / "bin"
    fake_bin.mkdir()
    (fake_bin / "g++").write_text(
        "#!/bin/sh\necho 'fatal error: no OpenMP' >&2\nexit 1\n")
    (fake_bin / "g++").chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake_bin}:{os.environ['PATH']}")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LOADED", {})
    with pytest.raises(native.NativeBuildError, match="no OpenMP"):
        native.build("nw")
    with pytest.raises(native.NativeBuildError, match="no OpenMP"):
        nw.nw_align("MKV", "MKV", matrices.ScoringMatrix.from_name(
            "BLOSUM62"))
    assert not list((tmp_path / "build").glob("*"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeBuildError, match="cannot run"):
        native.build("kmersearch")


def test_library_key_follows_cpu_and_flags(monkeypatch):
    """A library built for another CPU, with other flags or by another
    compiler is not reused."""
    here = native.library_path("nw")
    for attr, value in (("_cpu_signature", lambda: "another cpu"),
                        ("CXXFLAGS", native.CXXFLAGS + ("-g",)),
                        ("CXX", "clang++")):
        with monkeypatch.context() as m:
            m.setattr(native, attr, value)
            assert native.library_path("nw") != here
    assert native.library_path("nw") == here
