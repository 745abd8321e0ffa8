"""The port's host modules against the JAX package's, exact unless stated:
FASTA I/O, contact-map alignment and projection, the streaming checkpoint,
GO propagation, input sharding and merging, the blocklist, profiling and
its trace hook, the device NW wavefront, the package constants and the
utilities."""

import gzip
import json
import pickle
from pathlib import Path

import numpy as np
import pytest

import metagenomic_deepfri_tpu as jax_pkg
import metagenomic_deepfri_tpu.pipeline as jax_pipeline
from metagenomic_deepfri_tpu import bio_utils as jax_bio
from metagenomic_deepfri_tpu import checkpoint as jax_checkpoint
from metagenomic_deepfri_tpu import utils as jax_utils
from metagenomic_deepfri_tpu.align.pairwise import \
    AlignmentResult as JaxAlignmentResult
from metagenomic_deepfri_tpu.data import fasta as jax_fasta
from metagenomic_deepfri_tpu.align import matrices as jax_matrices
from metagenomic_deepfri_tpu.ontology import go as jax_go
from metagenomic_deepfri_tpu.ops import cmap_align as jax_cmap_align
from metagenomic_deepfri_tpu.ops import nw as jax_nw
from metagenomic_deepfri_tpu.parallel import multihost as jax_multihost
import metagenomic_deepfri_tpu_torch as pkg
from metagenomic_deepfri_tpu_torch import bio_utils, checkpoint, profiling
from metagenomic_deepfri_tpu_torch import pipeline, utils
from metagenomic_deepfri_tpu_torch.align import matrices
from metagenomic_deepfri_tpu_torch.align.pairwise import AlignmentResult
from metagenomic_deepfri_tpu_torch.data import fasta
from metagenomic_deepfri_tpu_torch.ontology import go
from metagenomic_deepfri_tpu_torch.ops import cmap_align, nw
from metagenomic_deepfri_tpu_torch.parallel import multihost

AAS = list("ACDEFGHIKLMNPQRSTVWY")
HEADER = pipeline.FINAL_OUTPUT_HEADER


def _random_seq(rng, n):
    return "".join(rng.choice(AAS, size=n))


# ---- FASTA ------------------------------------------------------------------

@pytest.mark.parametrize("gz", [False, True])
def test_fasta_matches_jax(gz, tmp_path):
    rng = np.random.default_rng(3)
    seqs = {f"p{i} description {i}": _random_seq(rng, int(rng.integers(1, 90)))
            for i in range(40)}
    name = "seqs.fasta.gz" if gz else "seqs.fasta"
    fasta.write_fasta(tmp_path / name, seqs, width=60)
    jax_fasta.write_fasta(tmp_path / f"jax_{name}", seqs, width=60)
    read = (gzip.open if gz else open)
    with read(tmp_path / name, "rb") as a, \
            read(tmp_path / f"jax_{name}", "rb") as b:
        assert a.read() == b.read()
    ours = fasta.load_fasta_as_dict(tmp_path / name)
    assert ours == jax_fasta.load_fasta_as_dict(tmp_path / name)
    assert list(fasta.iter_fasta(tmp_path / name)) == \
        list(jax_fasta.iter_fasta(tmp_path / name))
    assert len(ours) == 40
    wanted = ["p7", "p31", "p0"]
    assert fasta.retrieve_fasta_entries_as_dict(tmp_path / name, wanted) == \
        jax_fasta.retrieve_fasta_entries_as_dict(tmp_path / name, wanted)
    if not gz:
        index, jindex = (fasta.FastaIndex(tmp_path / name),
                         jax_fasta.FastaIndex(tmp_path / name))
        assert index.names() == jindex.names()
        assert all(index.fetch(n) == jindex.fetch(n) for n in index.names())
        assert ("p5" in index) == ("p5" in jindex)


# ---- contact-map alignment and projection ------------------------------------

def _alignments(n: int, seed: int):
    """(query, target, alignment string) triples with insertions and
    deletions, from the JAX package's NW on seeded near-copies."""
    from metagenomic_deepfri_tpu.align.matrices import ScoringMatrix
    from metagenomic_deepfri_tpu.ops.nw import nw_align

    rng = np.random.default_rng(seed)
    sm = ScoringMatrix.from_name("BLOSUM62")
    out = []
    for _ in range(n):
        t = _random_seq(rng, int(rng.integers(30, 160)))
        q = list(t)
        for pos in sorted(rng.choice(len(q), size=3, replace=False),
                          reverse=True):
            if rng.random() < 0.5:
                del q[pos]
            else:
                q.insert(pos, rng.choice(AAS))
        q = "".join(q)
        out.append((q, t, nw_align(q, t, sm)[1]))
    return out


def _coords(rng, n):
    steps = rng.normal(size=(n, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    return np.cumsum(3.8 * steps, axis=0).astype(np.float32)


def test_contact_map_alignment_matches_jax():
    rng = np.random.default_rng(8)
    for q, t, aln in _alignments(12, seed=4):
        ours_q, ours_t = AlignmentResult(q, q, "t", t, aln).gapped_sequence, \
            AlignmentResult(q, q, "t", t, aln).gapped_target
        coords = _coords(rng, len(t))
        from metagenomic_deepfri_tpu_torch.ops.contact import \
            calculate_contact_map
        sparse = np.argwhere(calculate_contact_map(coords, 6.0))
        for gen in (0, 2, 3):
            ours = cmap_align.align_contact_map(ours_q, ours_t, sparse, gen)
            theirs = jax_cmap_align.align_contact_map(ours_q, ours_t, sparse,
                                                      gen)
            assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)

        res = AlignmentResult("q", q, "t", t, aln, coords=coords)
        jres = JaxAlignmentResult("q", q, "t", t, aln, coords=coords)
        (_, (proj, ins)) = bio_utils.build_align_projection(res)
        (_, (jproj, jins)) = jax_bio.build_align_projection(jres)
        assert np.array_equal(proj, jproj) and np.array_equal(ins, jins)
        assert proj.dtype == np.float32 and ins.dtype == bool
        for thr, gen in ((6.0, 2), (8.0, 1)):
            _, cmap = bio_utils.build_align_contact_map(res, thr, gen)
            _, jcmap = jax_bio.build_align_contact_map(jres, thr, gen)
            assert cmap.dtype == jcmap.dtype and np.array_equal(cmap, jcmap)


def test_projection_failure_contract():
    """No coordinates: ``(alignment, None)`` from both functions; fewer
    coordinates than the target has residues: ``None`` from the projection,
    and from the contact map what the JAX package gives (its scatter drops
    the residues without coordinates)."""
    (q, t, aln), = _alignments(1, seed=9)
    for coords in (None, np.zeros((3, 3), np.float32)):
        res = AlignmentResult("q", q, "t", t, aln, coords=coords)
        jres = JaxAlignmentResult("q", q, "t", t, aln, coords=coords)
        assert bio_utils.build_align_projection(res)[1] is None
        assert jax_bio.build_align_projection(jres)[1] is None
        cmap = bio_utils.build_align_contact_map(res)[1]
        jcmap = jax_bio.build_align_contact_map(jres)[1]
        if coords is None:
            assert cmap is None and jcmap is None
        else:
            assert np.array_equal(cmap, jcmap)


# ---- checkpoint -------------------------------------------------------------

def _scores(seed, ids, n=5):
    rng = np.random.default_rng(seed)
    return {q: rng.random(n).astype(np.float32) for q in ids}


@pytest.mark.parametrize("writer,reader", [
    (checkpoint.PredictionCheckpoint, jax_checkpoint.PredictionCheckpoint),
    (jax_checkpoint.PredictionCheckpoint, checkpoint.PredictionCheckpoint)],
    ids=["port_to_jax", "jax_to_port"])
def test_checkpoint_cross_loads(writer, reader, tmp_path):
    """Parts and the overflow log written by one package resume in the
    other: scores, completed sets, pending overflow marks, merge order."""
    w = writer(tmp_path / "ckpt")
    w.add("gcn", {"mf": _scores(0, ["a", "b"]), "bp": _scores(1, ["a", "b"])})
    w.add("gcn", {"mf": _scores(2, ["c"]), "bp": _scores(3, ["c"])})
    w.add("cnn", {"mf": _scores(4, ["d"])})
    w.mark_overflow("gcn", "bp", ["a", "c"])
    w.mark_overflow("cnn", "mf", ["d"])
    w.resolve_overflow("cnn", "mf", ["d"])
    w.add("gcn", {"bp": _scores(5, ["a"])})  # a later part wins on reload

    r = reader(tmp_path / "ckpt")
    assert r.completed("gcn", ["mf", "bp"]) == {"a", "b", "c"}
    assert r.completed("cnn", ["mf"]) == {"d"}
    assert r.overflow("gcn") == {"bp": {"a", "c"}}
    assert not any(r.overflow("cnn").values())
    merged = {"mf": {}, "bp": {}}
    r.merge_into("gcn", merged)
    assert np.array_equal(merged["bp"]["a"], _scores(5, ["a"])["a"])
    assert np.array_equal(merged["mf"]["c"], _scores(2, ["c"])["c"])
    r.remove()
    assert not (tmp_path / "ckpt").exists()


# ---- GO propagation ---------------------------------------------------------

OBO = "\n".join([
    "format-version: 1.2", "",
    "[Term]", "id: GO:0000001", "name: child one",
    "is_a: GO:0000005 ! parent", "",
    "[Term]", "id: GO:0000002", "name: child two",
    "relationship: part_of GO:0000005 ! parent", "",
    "[Term]", "id: GO:0000005", "name: parent", "",
]) + "\n"


def test_propagate_results_byte_identical(tmp_path):
    (tmp_path / "go.obo").write_text(OBO)
    rows = [
        ["p1", "gcn", "GO Molecular Function", "GO:0000001", "0.9000",
         "child one", "True", "af_0", "structures", "0.95", "1.0", "1.0"],
        ["p1", "gcn", "GO Molecular Function", "GO:0000002", "0.4000",
         "child two", "True", "af_0", "structures", "0.95", "1.0", "1.0"],
        ["p2", "cnn", "GO Molecular Function", "GO:0000002", "0.2500",
         "child two", "False", "nan", "nan", "nan", "nan", "nan"],
        ["p2", "cnn", "Enzyme Commission", "3.1.1.1", "0.5000", "ec",
         "False", "nan", "nan", "nan", "nan", "nan"],
    ]
    results = tmp_path / "results.tsv"
    results.write_text("\n".join("\t".join(r) for r in [HEADER] + rows)
                       + "\n")
    go.propagate_results(results, tmp_path / "ours.tsv", tmp_path / "go.obo")
    jax_go.propagate_results(results, tmp_path / "jax.tsv",
                             tmp_path / "go.obo")
    ours = (tmp_path / "ours.tsv").read_bytes()
    assert ours == (tmp_path / "jax.tsv").read_bytes()
    assert b"GO:0000005" in ours
    dag = go.GoDag.from_obo(tmp_path / "go.obo")
    assert dag.ancestors("GO:0000001", ("is_a", "part_of"), True) == \
        jax_go.GoDag.from_obo(tmp_path / "go.obo").ancestors(
            "GO:0000001", ("is_a", "part_of"), True)


def test_download_obo_keeps_an_existing_file(tmp_path):
    (tmp_path / "go.obo").write_text(OBO)
    assert go.download_obo(tmp_path / "go.obo") == tmp_path / "go.obo"
    assert (tmp_path / "go.obo").read_text() == OBO


# ---- sharding ---------------------------------------------------------------

def test_shard_of_matches_jax():
    ids = [f"MGYP{i:012d}" for i in range(1000)]
    for count in (1, 2, 3, 8):
        ours = [multihost.shard_of(q, count) for q in ids]
        assert ours == [jax_multihost.shard_of(q, count) for q in ids]
        assert set(ours) == set(range(count))


def test_shard_fasta_and_merge_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    seqs = {f"q{i}": _random_seq(rng, 30 + i) for i in range(25)}
    fasta.write_fasta(tmp_path / "all.faa", seqs)
    for i in range(3):
        ours = multihost.shard_fasta(tmp_path / "all.faa",
                                     tmp_path / f"o{i}.faa", i, 3)
        theirs = jax_multihost.shard_fasta(tmp_path / "all.faa",
                                           tmp_path / f"j{i}.faa", i, 3)
        assert ours[1] == theirs[1]
        assert (tmp_path / f"o{i}.faa").read_bytes() == \
            (tmp_path / f"j{i}.faa").read_bytes()

    shards = []
    for s in range(2):
        d = tmp_path / f"shard{s}"
        d.mkdir()
        (d / "results.tsv").write_text(
            "\t".join(HEADER) + "\n" + f"p{s}\tgcn\tm\tGO:1\t0.5000\n")
        (d / "alignment_summary.tsv").write_text(
            "\t".join(pipeline.ALIGNMENT_HEADER) + "\n"
            + f"p{s}\tTrue\tt{s}\tdb\t1.0\t1.0\t1.0\n")
        (d / "prediction_matrix_mf.tsv").write_text(
            f"protein\tnetwork_type\tGO:1\np{s}\tgcn\t0.5\n")
        shards.append(d)
    ours = multihost.merge_shard_results(shards, tmp_path / "merged")
    theirs = jax_multihost.merge_shard_results(shards, tmp_path / "jmerged")
    assert [p.name for p in ours] == [p.name for p in theirs]
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes()


# ---- blocklist ----------------------------------------------------------------

def test_blocklist_shipped_asset(monkeypatch):
    monkeypatch.delenv("MDEEPFRI_BLOCKLIST", raising=False)
    blocklist = pipeline._load_blocklist("highquality_clust30")
    assert len(blocklist) == 27675
    assert "MGYP000008650329" in blocklist
    assert blocklist == jax_pipeline._load_blocklist("highquality_clust30")
    assert pipeline._load_blocklist("no_such_db") == set()


@pytest.mark.parametrize("kind", ["pkl", "txt", "txt.gz"])
def test_blocklist_from_environment(kind, tmp_path, monkeypatch):
    ids = ["AF-Q8WZ42-F1-model_v4.pdb", "AF-P12345-F1-model_v4.pdb"]
    path = tmp_path / f"blk.{kind}"
    if kind == "pkl":
        path.write_bytes(pickle.dumps(ids))
    elif kind == "txt":
        path.write_text("\n".join(ids) + "\n\n")
    else:
        with gzip.open(path, "wt") as f:
            f.write("\n".join(ids) + "\n")
    monkeypatch.setenv("MDEEPFRI_BLOCKLIST", str(path))
    assert pipeline._load_blocklist("any_db") == set(ids) == \
        jax_pipeline._load_blocklist("any_db")


# ---- profiling ----------------------------------------------------------------

def test_profiling_stages():
    profiling.reset()
    try:
        with profiling.stage("search/db", items=10):
            pass
        with profiling.stage("search/db", items=5, log=False):
            pass
        profiling.add_items("inference/gcn", items=7)
        rep = profiling.report()
        assert rep["search/db"]["calls"] == 2
        assert rep["search/db"]["items"] == 15
        assert rep["inference/gcn"] == {
            "calls": 0, "seconds": 0.0, "items": 7, "items_per_sec": None}
        profiling.log_report()
    finally:
        profiling.reset()
    assert profiling.report() == {}


@pytest.mark.parametrize("how", ["argument", "environment", "neither"])
def test_torch_trace(how, tmp_path, monkeypatch):
    """The trace hook writes a Chrome trace into the explicit directory,
    else into ``MDEEPFRI_TPU_TRACE_DIR``, and is a no-op without either."""
    import torch

    monkeypatch.delenv("MDEEPFRI_TPU_TRACE_DIR", raising=False)
    arg = tmp_path / "arg" if how == "argument" else None
    if how == "environment":
        monkeypatch.setenv("MDEEPFRI_TPU_TRACE_DIR", str(tmp_path / "env"))
    with profiling.torch_trace(arg):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    traces = sorted(tmp_path.rglob("*.json"))
    if how == "neither":
        assert traces == []
        return
    (trace,) = traces
    assert trace.parent == tmp_path / ("arg" if arg else "env")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)


# ---- device NW ---------------------------------------------------------------

def test_nw_device_matches_jax_and_host():
    """200 seeded pairs (8 queries × 25 targets, lengths 1–300, some
    near-copies) at gap settings (10, 1), (11, 1), (5, 2): the torch
    wavefront on the CPU equals the JAX wavefront and the host engine,
    exactly (int32)."""
    ours = matrices.ScoringMatrix.from_name("BLOSUM62")
    theirs = jax_matrices.ScoringMatrix.from_name("BLOSUM62")
    rng = np.random.default_rng(11)
    gaps = [(10, 1), (11, 1), (5, 2)]
    for i in range(8):
        q = _random_seq(rng, int(rng.integers(1, 301)))
        targets = []
        for j in range(25):
            if j % 5 == 0:  # a near-copy: ~20 % substitutions
                t = list(q)
                for pos in rng.choice(len(q), size=len(q) // 5,
                                      replace=False):
                    t[pos] = rng.choice(AAS)
                targets.append("".join(t))
            else:
                targets.append(_random_seq(rng, int(rng.integers(1, 301))))
        go, ge = gaps[i % 3]
        got = nw.nw_score_many_device(q, targets, ours, go, ge, device="cpu")
        assert got.dtype == np.int32 and got.shape == (25,)
        assert np.array_equal(got, jax_nw.nw_score_many_device(
            q, targets, theirs, go, ge))
        assert np.array_equal(got, nw.nw_score_many(q, targets, ours, go,
                                                    ge))
    empty = nw.nw_score_many_device("ACDE", [], ours, device="cpu")
    assert empty.shape == (0,) and empty.dtype == np.int32


# ---- constants and utilities ----------------------------------------------------

def test_package_constants_match_jax():
    assert pkg.DEEPFRI_MODES == jax_pkg.DEEPFRI_MODES
    assert pkg.cnn_model_links == jax_pkg.cnn_model_links
    assert pkg.gcn_model_links == jax_pkg.gcn_model_links


def test_generate_config_json_matches_jax(tmp_path):
    for version in ("1.0", "1.1"):
        dirs = {}
        for name in ("ours", "jax"):
            d = tmp_path / version / name
            d.mkdir(parents=True)
            for mode in ("bp", "cc", "mf", "ec"):
                (d / f"DeepCNN-MERGED_{mode}.onnx").write_bytes(b"")
                (d / f"DeepFRI-MERGED_GraphConv_gcd_512_{mode}.onnx"
                 ).write_bytes(b"")
            dirs[name] = d
        utils.generate_config_json(dirs["ours"], version)
        jax_utils.generate_config_json(dirs["jax"], version)
        ours = json.loads((dirs["ours"] / "model_config.json").read_text())
        theirs = json.loads((dirs["jax"] / "model_config.json").read_text())
        rel = (lambda cfg, root: {
            k: ({m: Path(p).relative_to(root).as_posix()
                 for m, p in v.items()} if isinstance(v, dict) else v)
            for k, v in cfg.items()})
        assert rel(ours, dirs["ours"]) == rel(theirs, dirs["jax"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="not found"):
        utils.generate_config_json(tmp_path / "empty", "1.1")


def test_run_command_and_cleanup(tmp_path, capsys):
    assert utils.run_command("echo one; echo two") == "one\ntwo\n"
    assert "one\ntwo" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="exit code 3"):
        utils.run_command("exit 3", echo=False)
    for name in ("db.fasta.gz", "db.fasta.gz.idx", "db.mmseqsDB",
                 "keep.txt"):
        (tmp_path / name).write_text("x")
    utils.remove_intermediate_files([tmp_path / "db.fasta.gz",
                                     tmp_path / "db.mmseqsDB"])
    assert [p.name for p in tmp_path.iterdir()] == ["keep.txt"]


def test_download_error_offline(tmp_path, monkeypatch):
    """An unreachable URL raises DownloadError (a RuntimeError, as in the
    JAX package) naming the URL; nothing is fetched here."""
    import urllib.error
    import urllib.request

    def offline(*args, **kwargs):
        raise urllib.error.URLError("network is unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", offline)
    with pytest.raises(utils.DownloadError,
                       match="example.invalid.*unreachable"):
        utils.download_file("https://example.invalid/x.onnx",
                            tmp_path / "x.onnx")
    assert issubclass(utils.DownloadError, RuntimeError)


def test_stdout_warn_matches_jax(capsys):
    for fn in (utils.stdout_warn, jax_utils.stdout_warn):
        fn("careful", UserWarning, "mod.py", 12)
    out, err = capsys.readouterr()
    first, second = out[:len(out) // 2], out[len(out) // 2:]
    assert first == second and "mod.py:12: UserWarning: careful" in first
    assert err == ""


# ---- contact_map.py ----------------------------------------------------------

def test_contact_map_api_matches_jax():
    from metagenomic_deepfri_tpu import contact_map as jax_cm
    from metagenomic_deepfri_tpu_torch import contact_map as cm

    rng = np.random.default_rng(8)
    steps = rng.normal(size=(60, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    xyz = np.cumsum(3.8 * steps, axis=0)
    for thr in (6.0, 8.0):
        got = cm.CAlphaCoordinates("s", xyz).calculate_contact_map(thr)
        ref = jax_cm.CAlphaCoordinates("s", xyz).calculate_contact_map(thr)
        assert got.cmap.dtype == ref.cmap.dtype
        np.testing.assert_array_equal(got.cmap, ref.cmap)
        np.testing.assert_array_equal(got.sparsify(), ref.sparsify())
        assert got.sparsify().dtype == np.int32
    dist = cm.CAlphaCoordinates("s", xyz).calculate_distance_map()
    np.testing.assert_array_equal(
        dist.distance_map,
        jax_cm.CAlphaCoordinates("s", xyz).calculate_distance_map()
        .distance_map)

    bad = [(lambda m: m.CAlphaCoordinates("s", np.zeros((4, 2))),
            ValueError, "CA coordinates"),
           (lambda m: m.CAlphaCoordinates("s", xyz).calculate_distance_map(
               "euclidean"), NotImplementedError, "unsupported"),
           (lambda m: m.DistanceMap(-np.ones((2, 2))), ValueError,
            "negative"),
           (lambda m: m.DistanceMap(np.ones((2, 2))), ValueError, "diagonal"),
           (lambda m: m.DistanceMap(np.array([[0.0, 1.0], [2.0, 0.0]])),
            ValueError, "asymmetric"),
           (lambda m: m.ContactMap(np.array([[1, 1], [0, 1]])), ValueError,
            "asymmetric"),
           (lambda m: m.ContactMap(np.full((2, 2), 2)), ValueError,
            "binary")]
    for make, exc, match in bad:
        for module in (cm, jax_cm):
            with pytest.raises(exc, match=match):
                make(module)
