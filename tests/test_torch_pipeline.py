"""The port's ``predict-function`` pipeline end to end against the JAX one.

Both packages load the same weights folder (tiny GCNs and CNNs made by the
JAX package's ``init_gcn``/``init_cnn`` and exported to ONNX). Each run gets
its own fresh copy of the fixture directory, at the same path one after the
other (the sequence database is written next to the structures and reused),
so the provenance paths inside the search tables are the same on both
sides. The port runs on ``device="cpu"``, where B1/B2 run their plain twins.

Compared, per run:

- ``database_search/*_results.tsv`` and ``alignment_summary.tsv``:
  byte-identical;
- ``contact_maps/*.npy``: equal;
- ``prediction_matrix_*.tsv``: same header and row order, values within
  atol 1e-5;
- ``results.tsv`` / ``results_propagated.tsv``: the same rows in the same
  order, every column byte-equal except the score, which may differ by one
  unit in the 4th decimal.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import jax

import metagenomic_deepfri_tpu.pipeline as jax_pipeline
from metagenomic_deepfri_tpu.data.fasta import write_fasta
from metagenomic_deepfri_tpu.data.structures import write_ca_pdb
from metagenomic_deepfri_tpu.models.deepfri import (CNNConfig, GCNConfig,
                                                    init_cnn, init_gcn)
from metagenomic_deepfri_tpu.models.onnx_import import (export_cnn_to_onnx,
                                                        export_gcn_to_onnx)
from metagenomic_deepfri_tpu.utils import generate_config_json
import metagenomic_deepfri_tpu_torch.pipeline as pipeline

MODES = ["bp", "cc", "mf", "ec"]
AAS = list("ACDEFGHIKLMNPQRSTVWY")
MATRIX_ATOL = 1e-5
SCORE_ATOL = 1e-4 + 1e-9     # one unit in the 4th decimal of "%.4f"

MINI_OBO = "\n".join([
    "format-version: 1.2", "",
    "[Term]", "id: GO:0000001", "name: child one",
    "is_a: GO:0000005 ! parent", "",
    "[Term]", "id: GO:0000002", "name: child two",
    "relationship: part_of GO:0000005 ! parent", "",
    "[Term]", "id: GO:0000005", "name: parent", "",
]) + "\n"


def write_weights(path: Path, n_labels: int, gcn_cfg, cnn_cfg, seed: int):
    """A model_config.json folder of ONNX GCNs and CNNs for every mode."""
    path.mkdir(parents=True, exist_ok=True)
    terms = [f"GO:{i:07d}" for i in range(n_labels)]
    names = [f"term {i}" for i in range(n_labels)]
    key = jax.random.PRNGKey(seed)
    for mode in MODES:
        k1, k2, key = jax.random.split(key, 3)
        gcn_name = (f"DeepFRI-MERGED_GraphConv_gcd_8-12_fcd_16_ca_10.0_"
                    f"{mode}.onnx")
        cnn_name = f"DeepCNN-MERGED_{mode}.onnx"
        export_gcn_to_onnx(init_gcn(k1, gcn_cfg), gcn_cfg,
                           str(path / gcn_name))
        export_cnn_to_onnx(init_cnn(k2, cnn_cfg), cnn_cfg,
                           str(path / cnn_name))
        for name in (gcn_name, cnn_name):
            with open(path / (name[:-5] + "_model_params.json"), "w") as f:
                json.dump({"goterms": terms, "gonames": names}, f)
    generate_config_json(path, "1.0")
    return path


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """The weights of ``tests/test_pipeline_regression.py``."""
    return write_weights(
        tmp_path_factory.mktemp("weights"), 6,
        GCNConfig(n_labels=6, lm_hidden=8, lm_layers=2, embed_dim=16,
                  gc_dims=(8, 12), fc_dims=(16,), adj_norm="none"),
        CNNConfig(n_labels=6, conv_filters=8, conv_kernels=(3, 5),
                  fc_dims=(16,)), seed=0)


def _walk(rng, n):
    steps = rng.normal(size=(n, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
    return np.cumsum(3.8 * steps, axis=0).astype(np.float32)


def _mutate(rng, seq, n):
    out = list(seq)
    for pos in rng.choice(len(seq), size=n, replace=False):
        out[pos] = rng.choice(AAS)
    return "".join(out)


def structure_fixture(root: Path, seed: int = 11, n_structures: int = 6,
                      hits=(("q_hit_a", 0, 3), ("q_hit_b", 3, 4))):
    """The fixture of ``test_structure_dir_database_end_to_end``: a
    directory of CA-trace PDB files, near-copy queries of some of them
    (``(query id, structure index, substitutions)``), one random query, a
    selenoprotein and a mini OBO."""
    rng = np.random.default_rng(seed)
    structures = root / "structures"
    structures.mkdir(parents=True)
    seqs = {}
    for i in range(n_structures):
        sid = f"af_{i}"
        seqs[sid] = "".join(rng.choice(AAS, size=70 + 10 * i))
        write_ca_pdb(structures / f"{sid}.pdb", seqs[sid],
                     _walk(rng, len(seqs[sid])))
    queries = {qid: _mutate(rng, seqs[f"af_{i}"], n) for qid, i, n in hits}
    queries["q_nohit"] = "".join(rng.choice(AAS, size=50))
    queries["q_seleno"] = "MKVU" + "".join(rng.choice(AAS, size=40))
    write_fasta(root / "queries.faa", queries)
    (root / "go-mini.obo").write_text(MINI_OBO)
    return root


@pytest.fixture(scope="module")
def structure_dir(tmp_path_factory):
    return structure_fixture(tmp_path_factory.mktemp("structure_fixture"))


@pytest.fixture(scope="module")
def fasta_dir(tmp_path_factory):
    """The fixture of ``test_full_pipeline``: a FASTA sequence database
    whose coordinates come from a seeded stand-in for the structure fetch."""
    rng = np.random.default_rng(42)
    root = tmp_path_factory.mktemp("fasta_fixture")

    def rand_seq(n):
        return "".join(rng.choice(AAS, size=n))

    queries = {"query_hit_1": rand_seq(80), "query_hit_2": rand_seq(120),
               "query_nohit": rand_seq(60),
               "query_seleno": "MKVU" + rand_seq(40)}
    targets = {"target_1": _mutate(rng, queries["query_hit_1"], 3),
               "target_2": _mutate(rng, queries["query_hit_2"], 4)}
    targets.update({f"decoy{i}": rand_seq(100) for i in range(10)})
    write_fasta(root / "queries.faa", queries)
    write_fasta(root / "targets.fasta", targets)
    (root / "targets.json").write_text(json.dumps(targets))
    return root


def fake_extract_calpha_coords(targets):
    """Random-walk coordinates of each target's length (seed 7), in place
    of the structure fetch."""
    def extract(db, target_ids, query_ids, save_directory=None, threads=1):
        rng = np.random.default_rng(7)
        return [_walk(rng, len(targets[tid])) for tid in target_ids]
    return extract


def run_pipeline(backend: str, fixture: Path, run_dir: Path, weights,
                 db: str = "structures", **kwargs) -> Path:
    """Search and predict with one package on a fresh copy of ``fixture``
    at ``run_dir``; the outputs are moved to ``<run_dir>_<backend>``."""
    pl = jax_pipeline if backend == "jax" else pipeline
    if backend == "torch":
        kwargs.setdefault("device", "cpu")
    shutil.rmtree(run_dir, ignore_errors=True)
    shutil.copytree(fixture, run_dir)
    out = run_dir / "results"
    shard = kwargs.pop("shard", None)
    qf = pl.load_query_file(run_dir / "queries.faa", shard=shard)
    dbs = pl.hierarchical_database_search(
        query_file=qf, output_path=out / "database_search",
        databases=[run_dir / db], skip_pdb=True, max_eval=1e-3, threads=2)
    qf2 = pl.load_query_file(run_dir / "queries.faa", shard=shard)
    if "obo_path" in kwargs:
        kwargs["obo_path"] = run_dir / kwargs["obo_path"]
    pl.predict_protein_function(query_file=qf2, databases=tuple(dbs),
                                weights=weights, output_path=out, threads=2,
                                **kwargs)
    kept = run_dir.with_name(f"{run_dir.name}_{backend}")
    shutil.rmtree(kept, ignore_errors=True)
    run_dir.rename(kept)
    return kept / "results"


def _result_rows(path: Path):
    lines = path.read_text().split("\n")
    assert lines[-1] == ""
    return lines[0], [ln.split("\t") for ln in lines[1:-1]]


def assert_results_match(jax_path: Path, torch_path: Path) -> int:
    """Same header, same rows in the same order; every column byte-equal
    but the score (index 4), within one unit of its 4th decimal."""
    jh, jrows = _result_rows(jax_path)
    th, trows = _result_rows(torch_path)
    assert jh == th
    assert [r[:4] + r[5:] for r in jrows] == [r[:4] + r[5:] for r in trows]
    for jr, tr in zip(jrows, trows):
        assert abs(float(jr[4]) - float(tr[4])) <= SCORE_ATOL, (jr, tr)
    return len(jrows)


def assert_outputs_match(jax_out: Path, torch_out: Path, cmaps: bool,
                         propagated: bool) -> None:
    search = sorted(p.name for p in
                    (jax_out / "database_search").glob("*_results.tsv"))
    assert search and search == sorted(
        p.name for p in (torch_out / "database_search").glob("*_results.tsv"))
    for name in search:
        assert ((torch_out / "database_search" / name).read_bytes()
                == (jax_out / "database_search" / name).read_bytes()), name
    assert ((torch_out / "alignment_summary.tsv").read_bytes()
            == (jax_out / "alignment_summary.tsv").read_bytes())

    if cmaps:
        names = sorted(p.name for p in (jax_out / "contact_maps").glob("*"))
        assert names and names == sorted(
            p.name for p in (torch_out / "contact_maps").glob("*"))
        for name in names:
            a = np.load(jax_out / "contact_maps" / name)
            b = np.load(torch_out / "contact_maps" / name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name

    matrices = sorted(p.name for p in jax_out.glob("prediction_matrix_*"))
    assert matrices == sorted(
        p.name for p in torch_out.glob("prediction_matrix_*"))
    for name in matrices:
        ja = (jax_out / name).read_text().splitlines()
        ta = (torch_out / name).read_text().splitlines()
        assert ja[0] == ta[0] and len(ja) == len(ta), name
        for jl, tl in zip(ja[1:], ta[1:]):
            jc, tc = jl.split("\t"), tl.split("\t")
            assert jc[:2] == tc[:2], name
            np.testing.assert_allclose(np.asarray(tc[2:], np.float64),
                                       np.asarray(jc[2:], np.float64),
                                       rtol=0, atol=MATRIX_ATOL)

    assert assert_results_match(jax_out / "results.tsv",
                                torch_out / "results.tsv") > 0
    if propagated:
        assert assert_results_match(jax_out / "results_propagated.tsv",
                                    torch_out / "results_propagated.tsv") > 0


def test_structure_dir_pipeline_matches_jax(weights_dir, structure_dir,
                                            tmp_path):
    """``test_structure_dir_database_end_to_end`` on both packages, with
    saved contact maps and GO propagation."""
    kw = dict(deepfri_processing_modes=["mf", "bp"], save_cmaps=True,
              propagate_go_terms=True, obo_path="go-mini.obo")
    outs = {b: run_pipeline(b, structure_dir, tmp_path / "run", weights_dir,
                            **kw) for b in ("jax", "torch")}
    assert_outputs_match(outs["jax"], outs["torch"], cmaps=True,
                         propagated=True)
    summary = (outs["torch"] / "alignment_summary.tsv").read_text()
    rows = {r.split("\t")[0]: r.split("\t") for r in summary.splitlines()[1:]}
    assert rows["q_hit_a"][1:3] == ["True", "af_0"]
    assert rows["q_hit_b"][1:3] == ["True", "af_3"]
    assert rows["q_nohit"][1] == "False" and "q_seleno" not in rows


def test_fasta_db_pipeline_matches_jax(weights_dir, fasta_dir, tmp_path,
                                       monkeypatch):
    """``test_full_pipeline`` on both packages: a FASTA database, the
    structure fetch replaced by the same seeded coordinates on both sides,
    BLOSUM62, every mode."""
    targets = json.loads((fasta_dir / "targets.json").read_text())
    for mod in (jax_pipeline, pipeline):
        monkeypatch.setattr(mod, "extract_calpha_coords",
                            fake_extract_calpha_coords(targets))
    kw = dict(deepfri_processing_modes=list(MODES), save_cmaps=True,
              scoring_matrix="BLOSUM62")
    outs = {b: run_pipeline(b, fasta_dir, tmp_path / "run", weights_dir,
                            db="targets.fasta", **kw)
            for b in ("jax", "torch")}
    assert_outputs_match(outs["jax"], outs["torch"], cmaps=True,
                         propagated=False)
    results = (outs["torch"] / "results.tsv").read_text()
    assert {ln.split("\t")[2] for ln in results.splitlines()[1:]} == {
        "GO Biological Process", "GO Cellular Component",
        "GO Molecular Function", "Enzyme Commission"}


def test_skip_matrix_topk_results_identical(tmp_path):
    """``test_skip_matrix_topk_results_identical`` on the port: a 600-term
    head with uncalibrated random weights (about half of all terms ≥ 0.1).
    The port's ``skip_matrix`` run writes no matrix and the ``results.tsv``
    of its matrix run, byte for byte; its rows match both the JAX matrix
    run's and the JAX ``skip_matrix`` run's, where every protein overflows
    the top-256 fetch and is re-run densely."""
    n_labels = 600
    weights = write_weights(
        tmp_path / "weights", n_labels,
        GCNConfig(n_labels=n_labels, lm_hidden=8, lm_layers=1, embed_dim=16,
                  gc_dims=(8, 12), fc_dims=(16,)),
        CNNConfig(n_labels=n_labels, conv_filters=8, conv_kernels=(3,),
                  fc_dims=(16,)), seed=9)
    fixture = structure_fixture(tmp_path / "fixture", seed=33,
                                n_structures=3, hits=(("q_hit", 0, 3),))
    run = tmp_path / "run"
    dense = run_pipeline("torch", fixture, run, weights,
                         deepfri_processing_modes=["mf"])
    skip = run_pipeline("torch", fixture, tmp_path / "run_skip", weights,
                        deepfri_processing_modes=["mf"], skip_matrix=True)
    ref = run_pipeline("jax", fixture, tmp_path / "run_ref", weights,
                       deepfri_processing_modes=["mf"])
    ref_topk = run_pipeline("jax", fixture, tmp_path / "run_ref_topk",
                            weights, deepfri_processing_modes=["mf"],
                            skip_matrix=True)
    assert list(dense.glob("prediction_matrix_*"))
    assert not list(skip.glob("prediction_matrix_*"))
    assert (skip / "results.tsv").read_bytes() == \
        (dense / "results.tsv").read_bytes()
    assert assert_results_match(ref / "results.tsv",
                                dense / "results.tsv") > 3 * 256
    assert assert_results_match(ref_topk / "results.tsv",
                                skip / "results.tsv") > 3 * 256


# ---- the port's pipeline on its own -----------------------------------------

def _crashed_run(weights, structure_dir, run, monkeypatch):
    """Search, then a predict run killed after inference (its streaming
    checkpoint written, no ``results.tsv``); returns the resume call."""
    from metagenomic_deepfri_tpu_torch.batching.engine import \
        BatchedPredictor

    shutil.copytree(structure_dir, run)
    out = run / "results"
    qf = pipeline.load_query_file(run / "queries.faa")
    dbs = pipeline.hierarchical_database_search(
        query_file=qf, output_path=out / "database_search",
        databases=[run / "structures"], skip_pdb=True, max_eval=1e-3,
        threads=2)
    real_cnn = BatchedPredictor.predict_cnn

    def crashing_cnn(self, items, modes=None, progress_cb=None,
                     result_cb=None, **kw):
        real_cnn(self, items, modes=modes, progress_cb=progress_cb,
                 result_cb=result_cb, **kw)
        raise RuntimeError("simulated crash after inference")

    def predict():
        pipeline.predict_protein_function(
            query_file=pipeline.load_query_file(run / "queries.faa"),
            databases=tuple(dbs), weights=weights, output_path=out,
            deepfri_processing_modes=["mf"], threads=2, device="cpu")

    monkeypatch.setattr(BatchedPredictor, "predict_cnn", crashing_cnn)
    with pytest.raises(RuntimeError, match="simulated crash"):
        predict()
    assert list((out / "checkpoints").glob("part-*.npz"))
    assert not (out / "results.tsv").exists()
    monkeypatch.setattr(BatchedPredictor, "predict_cnn", real_cnn)
    return predict


def test_crash_resume_from_checkpoint(weights_dir, structure_dir, tmp_path,
                                      monkeypatch, caplog):
    """A run killed after inference resumes from the streaming checkpoint:
    the rerun skips the completed queries and writes the results.tsv of an
    uninterrupted run."""
    import logging

    clean = run_pipeline("torch", structure_dir, tmp_path / "clean",
                         weights_dir, deepfri_processing_modes=["mf"])
    out = tmp_path / "run" / "results"
    resume = _crashed_run(weights_dir, structure_dir, tmp_path / "run",
                          monkeypatch)
    caplog.set_level(logging.INFO)
    resume()
    assert "Checkpoint resume: skipping 2 GCN and 1 CNN queries" \
        in caplog.text
    assert not (out / "checkpoints").exists()
    assert (out / "results.tsv").read_bytes() == \
        (clean / "results.tsv").read_bytes()


def test_crash_resume_recomputes_overflow_marked_query(
        weights_dir, structure_dir, tmp_path, monkeypatch, caplog):
    """A checkpoint whose ``overflow.log`` (written by the JAX package's
    checkpoint) still marks one GCN query ``OVER``, its newest part holding
    a truncated row: the resumed run recomputes that query and writes the
    results.tsv of an uninterrupted run, byte for byte."""
    import logging

    from metagenomic_deepfri_tpu.checkpoint import \
        PredictionCheckpoint as JaxCheckpoint

    clean = run_pipeline("torch", structure_dir, tmp_path / "clean",
                         weights_dir, deepfri_processing_modes=["mf"])
    assert "q_hit_a\t" in (clean / "results.tsv").read_text()
    out = tmp_path / "run" / "results"
    resume = _crashed_run(weights_dir, structure_dir, tmp_path / "run",
                          monkeypatch)
    jax_ckpt = JaxCheckpoint(out / "checkpoints")
    row = jax_ckpt.scores("gcn")["mf"]["q_hit_a"]
    jax_ckpt.add("gcn", {"mf": {"q_hit_a": np.zeros_like(row)}})
    jax_ckpt.mark_overflow("gcn", "mf", ["q_hit_a"])
    caplog.set_level(logging.INFO)
    resume()
    assert "dropped 1 truncated score vector(s)" in caplog.text
    assert "Checkpoint resume: skipping 1 GCN and 1 CNN queries" \
        in caplog.text
    assert not (out / "checkpoints").exists()
    assert (out / "results.tsv").read_bytes() == \
        (clean / "results.tsv").read_bytes()


def test_sharded_pipeline_merge_equals_unsharded(weights_dir, structure_dir,
                                                 tmp_path):
    """Two ``--shard I/2`` halves merged with ``merge_shard_results`` give
    the rows of one unsharded run, and partition the queries."""
    from metagenomic_deepfri_tpu_torch.parallel.multihost import \
        merge_shard_results

    kw = dict(deepfri_processing_modes=["mf"], skip_matrix=True)
    full = run_pipeline("torch", structure_dir, tmp_path / "full",
                        weights_dir, **kw)
    halves = [run_pipeline("torch", structure_dir, tmp_path / f"s{i}",
                           weights_dir, shard=f"{i}/2", **kw)
              for i in range(2)]
    merged = tmp_path / "merged"
    merge_shard_results(halves, merged)

    def rows(path):
        lines = path.read_text().strip().split("\n")
        return lines[0], sorted(lines[1:])

    assert rows(merged / "results.tsv") == rows(full / "results.tsv")
    assert rows(full / "results.tsv")[1]
    ids = [{ln.split("\t")[0] for ln in
            (h / "results.tsv").read_text().strip().split("\n")[1:]}
           for h in halves]
    assert not ids[0] & ids[1]
    assert ids[0] | ids[1] == {"q_hit_a", "q_hit_b", "q_nohit"}


@pytest.mark.parametrize("skip_matrix", [False, True])
def test_device_list_pipeline_equals_one_device(weights_dir, structure_dir,
                                                tmp_path, skip_matrix):
    """``device=["cpu", "cpu"]``: the engine data-parallel over two
    replicas; ``results.tsv`` and the matrices are the one-device run's,
    byte for byte."""
    kw = dict(deepfri_processing_modes=["mf", "bp"], skip_matrix=skip_matrix)
    one = run_pipeline("torch", structure_dir, tmp_path / "one", weights_dir,
                       **kw)
    two = run_pipeline("torch", structure_dir, tmp_path / "two", weights_dir,
                       device=["cpu", "cpu"], **kw)
    names = sorted(p.name for p in one.glob("*.tsv"))
    assert "results.tsv" in names
    assert names == sorted(p.name for p in two.glob("*.tsv"))
    for name in names:
        assert (two / name).read_bytes() == (one / name).read_bytes(), name


def test_ec_dropped_for_v11():
    assert pipeline._initialize_processing_modes(
        ["mf", "ec"], {"version": "1.1"}) == ["mf"]
    assert pipeline._initialize_processing_modes(
        ["mf", "ec"], {"version": "1.0"}) == ["mf", "ec"]
    with pytest.raises(ValueError, match="No processing modes"):
        pipeline._initialize_processing_modes(["ec"], {"version": "1.1"})


def test_producer_exception_surfaces(weights_dir, structure_dir, tmp_path,
                                     monkeypatch):
    """An exception raised on the producer thread (alignment, coordinates,
    projection) ends the GCN stream and is raised after the join."""
    def broken(aln):
        raise ValueError(f"projection of {aln.query_name} failed")

    monkeypatch.setattr(pipeline, "build_align_projection", broken)
    with pytest.raises(ValueError, match="projection of q_hit_.* failed"):
        run_pipeline("torch", structure_dir, tmp_path / "run", weights_dir,
                     deepfri_processing_modes=["mf"])
    assert not (tmp_path / "run" / "results" / "results.tsv").exists()


def test_predict_requires_device(weights_dir, structure_dir, tmp_path):
    qf = pipeline.load_query_file(structure_dir / "queries.faa")
    with pytest.raises(TypeError, match="device"):
        pipeline.predict_protein_function(
            query_file=qf, databases=(), weights=weights_dir,
            output_path=tmp_path / "out", deepfri_processing_modes=["mf"])


def test_pipeline_starts_no_warmup(weights_dir, structure_dir, tmp_path,
                                   monkeypatch):
    """The pipeline starts no engine warmup, on the CPU nor on a GPU (here:
    the CPU engine taken for one): on the H100 it slowed a fresh run."""
    from metagenomic_deepfri_tpu_torch.batching.engine import \
        BatchedPredictor

    def warmup(self, buckets):
        raise AssertionError("the pipeline started a warmup")

    monkeypatch.setattr(BatchedPredictor, "warmup", warmup)
    monkeypatch.setattr(BatchedPredictor, "on_cuda", True)
    out = run_pipeline("torch", structure_dir, tmp_path / "run", weights_dir,
                       deepfri_processing_modes=["mf"])
    assert (out / "results.tsv").exists()


def _printf_rows(prefixes, rows) -> bytes:
    """Rows as the pipeline formatted them before ``native/tsvfmt.cpp``:
    ``np.char.mod("%.9g")`` joined by tabs."""
    return "".join(
        p + "\t".join(np.char.mod(
            "%.9g", np.asarray(r, dtype=np.float64)).tolist()) + "\n"
        for p, r in zip(prefixes, rows)).encode("utf-8")


def test_matrices_byte_equal_to_printf_formatter(weights_dir, structure_dir,
                                                 tmp_path, monkeypatch):
    """Every ``prediction_matrix_*.tsv`` of a run is byte-equal to what the
    ``np.char.mod("%.9g")`` formatter writes for the same scores, GCN rows
    and CNN rows alike, after the header."""
    from metagenomic_deepfri_tpu_torch.native import tsvfmt

    seen = {}
    write_rows = tsvfmt.write_rows

    def spy(fh, prefixes, rows):
        seen[Path(fh.name).name] = (list(prefixes),
                                    [np.array(r) for r in rows])
        return write_rows(fh, prefixes, rows)

    monkeypatch.setattr(tsvfmt, "write_rows", spy)
    out = run_pipeline("torch", structure_dir, tmp_path / "run", weights_dir,
                       deepfri_processing_modes=["mf", "bp", "cc"])
    names = sorted(p.name for p in out.glob("prediction_matrix_*"))
    assert names == sorted(seen) and len(names) == 3
    for name in names:
        got = (out / name).read_bytes()
        header, _, body = got.partition(b"\n")
        assert header == "\t".join(
            ["protein", "network_type"]
            + [f"GO:{i:07d}" for i in range(6)]).encode()
        prefixes, rows = seen[name]
        assert {p.split("\t")[1] for p in prefixes} == {"gcn", "cnn"}
        assert all(r.dtype == np.float32 for r in rows)
        assert body == _printf_rows(prefixes, rows), name


def test_write_matrices_span_counts_rows_and_cells(weights_dir,
                                                   structure_dir, tmp_path):
    """While recording, each ``write/matrices`` span counts the rows and the
    scores it formatted: every row of every matrix, 6 terms each."""
    from metagenomic_deepfri_tpu_torch import profiling

    profiling.set_recording(True)
    try:
        profiling.reset()
        out = run_pipeline("torch", structure_dir, tmp_path / "run",
                           weights_dir, deepfri_processing_modes=["mf", "bp"])
        got = [s for s in profiling.spans() if s.name == "write/matrices"]
    finally:
        profiling.set_recording(None)
        profiling.reset()
    lines = [len((out / f"prediction_matrix_{m}.tsv").read_text()
                 .splitlines()) - 1 for m in ("bp", "mf")]
    assert len(got) == 2 and min(lines) >= 3
    assert sorted(s.counts["rows"] for s in got) == sorted(lines)
    assert [s.counts["cells"] for s in got] == \
        [6 * s.counts["rows"] for s in got]
