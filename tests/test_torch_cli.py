"""The port's command line (argparse) against the JAX package's (click):
the verbs and their help, ``predict-function`` on the CPU equal to calling
the pipeline's functions, ``make-cmaps`` and ``generate-config`` equal to
the JAX verbs' files, clean offline errors, and usage errors."""

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

from metagenomic_deepfri_tpu.cli import main as jax_main
from metagenomic_deepfri_tpu_torch import __version__, cli
from test_torch_pipeline import run_pipeline, structure_fixture, \
    write_weights

REPO = Path(__file__).resolve().parent.parent
VERBS = ["search-databases", "predict-function", "make-cmaps",
         "generate-config", "get-models", "get-binaries", "finetune",
         "merge-results", "verify-weights", "serve", "benchmark"]


@pytest.fixture(autouse=True)
def restore_logging():
    """Both command lines point the root logger at the sys.stdout of their
    call (pytest's capture here), and the JAX one sets every logger's level
    (torch's too); put the handlers and levels back afterwards."""
    import logging

    root = logging.getLogger()
    handlers = root.handlers[:]
    levels = {name: logging.getLogger(name).level
              for name in list(logging.root.manager.loggerDict)}
    levels[None] = root.level
    yield
    root.handlers[:] = handlers
    for name, level in levels.items():
        logging.getLogger(name).setLevel(level)


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    from metagenomic_deepfri_tpu.models.deepfri import CNNConfig, GCNConfig

    return write_weights(
        tmp_path_factory.mktemp("weights"), 6,
        GCNConfig(n_labels=6, lm_hidden=8, lm_layers=1, embed_dim=16,
                  gc_dims=(8, 12), fc_dims=(16,), adj_norm="none"),
        CNNConfig(n_labels=6, conv_filters=8, conv_kernels=(3,),
                  fc_dims=(16,)), seed=4)


def test_group_help_and_version(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert all(v in out for v in VERBS) and "--debug" in out
    with pytest.raises(SystemExit) as exc:
        cli.main(["--version"])
    assert exc.value.code == 0 and __version__ in capsys.readouterr().out


@pytest.mark.parametrize("verb", VERBS)
def test_verb_help(verb, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main([verb, "--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("usage:")
    if verb in ("search-databases", "predict-function"):
        for flag in ("--mmseqs-min-coverage", "--mmseqs-max-evalue",
                     "--top-k", "--skip-pdb", "--shard", "--db-path"):
            assert flag in out
    assert ("--device" in out) == (
        verb in ("predict-function", "finetune", "verify-weights", "serve",
                 "benchmark"))


def _no_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_usage_error_prints_full_help_and_exits_2(tmp_path, capsys,
                                                  monkeypatch):
    """A usage error prints the verb's help and exits 2. ``--device``
    defaults to ``cuda``: without a CUDA device the verb exits 1 with an
    error naming the device, and runs nothing on the CPU instead."""
    _no_cuda(monkeypatch)
    (tmp_path / "q.faa").write_text(">a\nMKV\n")
    argv = ["predict-function", "-i", str(tmp_path / "q.faa"),
            "-o", str(tmp_path / "out"), "-w", str(tmp_path)]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv[:-2])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--mmseqs-min-coverage" in err and "--save-cmaps" in err
    assert "error: the following arguments are required: -w" in err
    assert cli.main(argv) == 1
    assert "Error: --device cuda: cuda not found (0 CUDA devices visible)" \
        in capsys.readouterr().err
    assert cli.main(argv + ["--device", "cuda:0,cuda:1"]) == 1
    assert "--device cuda:0,cuda:1" in capsys.readouterr().err
    for bad in (["predict-function", "-i", str(tmp_path / "missing.faa")],
                ["search-databases", "-i", str(tmp_path / "q.faa"), "-o",
                 str(tmp_path / "o"), "-s", "9"],
                ["no-such-verb"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(bad)
        assert exc.value.code == 2
    assert not (tmp_path / "out").exists()


def test_predict_function_cli_equals_functions(weights_dir, tmp_path):
    """``predict-function`` through ``cli.main`` writes the files that
    calling ``load_query_file``, ``hierarchical_database_search`` and
    ``predict_protein_function`` writes, byte for byte."""
    fixture = structure_fixture(tmp_path / "fixture")
    run = tmp_path / "run"
    kw = dict(deepfri_processing_modes=["mf", "cc"], save_cmaps=True,
              propagate_go_terms=True, obo_path="go-mini.obo")
    direct = run_pipeline("torch", fixture, run, weights_dir, **kw)

    shutil.copytree(fixture, run)
    assert cli.main([
        "predict-function", "-i", str(run / "queries.faa"),
        "-d", str(run / "structures"), "-w", str(weights_dir),
        "-o", str(run / "results"), "--skip-pdb", "--mmseqs-max-evalue",
        "1e-3", "-t", "2", "-p", "mf", "-p", "cc", "--save-cmaps",
        "--propagate-go-terms", "--obo-path", str(run / "go-mini.obo"),
        "--device", "cpu"]) == 0
    via_cli = run / "results"
    files = sorted(p.relative_to(direct).as_posix()
                   for p in direct.rglob("*") if p.is_file())
    assert "results_propagated.tsv" in files
    assert "database_search/structures_results.tsv" in files
    assert files == sorted(p.relative_to(via_cli).as_posix()
                           for p in via_cli.rglob("*") if p.is_file())
    for name in files:
        assert (via_cli / name).read_bytes() == (direct / name).read_bytes(), \
            name


def test_predict_function_trace_dir(weights_dir, tmp_path, monkeypatch):
    """With ``MDEEPFRI_TPU_TRACE_DIR`` set, ``predict-function`` runs under
    the profiler: its Chrome trace holds the host operators and the
    program's spans, on the trace's own time base (a batch's operators lie
    inside its ``engine/batch`` span, on its thread)."""
    fixture = structure_fixture(tmp_path / "fixture")
    monkeypatch.setenv("MDEEPFRI_TPU_TRACE_DIR", str(tmp_path / "trace"))
    assert cli.main([
        "predict-function", "-i", str(fixture / "queries.faa"),
        "-d", str(fixture / "structures"), "-w", str(weights_dir),
        "-o", str(tmp_path / "out"), "--skip-pdb", "--mmseqs-max-evalue",
        "1e-3", "-t", "2", "-p", "mf", "-p", "cc", "--device", "cpu"]) == 0
    (trace,) = (tmp_path / "trace").glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    ops = [e for e in events if str(e.get("name")).startswith("aten::")]
    spans = [e for e in events if e.get("cat") == "span"]
    assert ops and spans
    assert {"search/structures", "kmer/prefilter", "nw/rescore",
            "nw/traceback", "engine/batch", "engine/pack", "engine/unpack",
            "engine/emit", "model/lm", "model/graph",
            "model/head"} <= {e["name"] for e in spans}
    for batch in (e for e in spans if e["name"] == "engine/batch"):
        assert batch["args"]["rows"] >= 1
        assert any(op["tid"] == batch["tid"] and batch["ts"] <= op["ts"]
                   and op["ts"] + op["dur"] <= batch["ts"] + batch["dur"]
                   for op in ops)


def test_search_databases_and_merge_results(weights_dir, tmp_path):
    fixture = structure_fixture(tmp_path / "fixture")
    assert cli.main([
        "search-databases", "-i", str(fixture / "queries.faa"),
        "-d", str(fixture / "structures"), "-o", str(tmp_path / "search"),
        "--skip-pdb", "--mmseqs-max-evalue", "1e-3"]) == 0
    table = (tmp_path / "search" / "structures_results.tsv").read_text()
    assert {ln.split("\t")[0] for ln in table.splitlines()[1:]} == \
        {"q_hit_a", "q_hit_b"}

    shards = []
    for i in range(2):
        d = tmp_path / f"shard{i}"
        d.mkdir()
        (d / "results.tsv").write_text(f"protein\tscore\np{i}\t0.5000\n")
        shards.append(str(d))
    assert cli.main(["merge-results", *shards, "-o",
                     str(tmp_path / "merged")]) == 0
    assert (tmp_path / "merged" / "results.tsv").read_text() == \
        "protein\tscore\np0\t0.5000\np1\t0.5000\n"


def test_make_cmaps_matches_jax_verb(tmp_path):
    from metagenomic_deepfri_tpu_torch.data.structures import write_ca_pdb

    rng = np.random.default_rng(6)
    (tmp_path / "in").mkdir()
    for i, n in enumerate((3, 40, 97)):
        steps = rng.normal(size=(n, 3))
        steps /= np.linalg.norm(steps, axis=1, keepdims=True)
        write_ca_pdb(tmp_path / "in" / f"s{i}.pdb",
                     "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)),
                     np.cumsum(3.8 * steps, axis=0).astype(np.float32))
    (tmp_path / "in" / "readme.txt").write_text("skipped\n")
    for thr in ("6.0", "8.5"):
        assert cli.main(["make-cmaps", "-i", str(tmp_path / "in"), "-o",
                         str(tmp_path / f"ours{thr}"), "-t", thr]) == 0
        res = CliRunner().invoke(jax_main, [
            "make-cmaps", "-i", str(tmp_path / "in"), "-o",
            str(tmp_path / f"jax{thr}"), "-t", thr])
        assert res.exit_code == 0, res.output
        names = sorted(p.name for p in (tmp_path / f"jax{thr}").iterdir())
        assert names == ["s0_cmap.npy", "s1_cmap.npy", "s2_cmap.npy"]
        assert names == sorted(p.name for p in
                               (tmp_path / f"ours{thr}").iterdir())
        for name in names:
            a = np.load(tmp_path / f"ours{thr}" / name)
            b = np.load(tmp_path / f"jax{thr}" / name)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_generate_config_matches_jax_verb(weights_dir, tmp_path):
    for name in ("ours", "jax"):
        shutil.copytree(weights_dir, tmp_path / name)
        (tmp_path / name / "model_config.json").unlink()
    assert cli.main(["generate-config", "-w", str(tmp_path / "ours"),
                     "-v", "1.0"]) == 0
    res = CliRunner().invoke(jax_main, ["generate-config", "-w",
                                        str(tmp_path / "jax"), "-v", "1.0"])
    assert res.exit_code == 0, res.output
    ours = (tmp_path / "ours" / "model_config.json").read_text()
    theirs = (tmp_path / "jax" / "model_config.json").read_text()
    assert ours == theirs.replace(str(tmp_path / "jax"),
                                  str(tmp_path / "ours"))
    assert json.loads(ours)["version"] == "1.0"


@pytest.mark.parametrize("argv", [
    ["get-models", "-v", "1.1"], ["get-binaries", "--tools", "mmseqs"]],
    ids=["get-models", "get-binaries"])
def test_network_verbs_offline(argv, tmp_path, monkeypatch, capsys):
    """Without a network the verb exits 1 with the failing URL, not a
    traceback. No request leaves this process: ``urlopen`` is replaced."""
    def offline(*args, **kwargs):
        raise urllib.error.URLError("network is unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", offline)
    assert cli.main(argv + ["-o", str(tmp_path / "out")]) == 1
    err = capsys.readouterr().err
    assert err.startswith("Error: Download of https://")
    assert "unreachable" in err and "Traceback" not in err


def test_module_entry_point(tmp_path):
    """``python -m metagenomic_deepfri_tpu_torch.cli``: exit 2 and the full
    help on a usage error, in a fresh interpreter."""
    proc = subprocess.run(
        [sys.executable, "-m", "metagenomic_deepfri_tpu_torch.cli",
         "make-cmaps", "-i", str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 2
    assert "--threshold" in proc.stderr and "--output_dir" in proc.stderr


def _verb_actions(verb):
    sub = next(a for a in cli._parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[verb]._option_string_actions


def _serve_actions():
    return _verb_actions("serve")


def test_serve_parser_matches_jax_verb(tmp_path, capsys, monkeypatch):
    """``serve`` has the JAX verb's options and defaults, plus ``--device``
    (default ``cuda``, an error without one)."""
    _no_cuda(monkeypatch)
    jax_serve = jax_main.commands["serve"]
    ours = _serve_actions()
    jax_opts = {o: p for p in jax_serve.params for o in p.opts}
    assert set(ours) - set(jax_opts) == {"--device", "-h", "--help"}
    assert set(jax_opts) - set(ours) == set()
    for opt in ("-t", "--top-k", "--mmseqs-max-evalue",
                "--mmseqs-min-identity", "--mmseqs-min-coverage"):
        assert ours[opt].default == jax_opts[opt].default, opt
    assert ours["--socket"].required and not ours["--device"].required
    assert ours["--device"].default == "cuda"
    assert ours["-p"].choices == list(jax_opts["-p"].type.choices)
    assert cli.main(["serve", "-w", str(tmp_path), "--socket",
                     str(tmp_path / "s.sock")]) == 1
    assert "Error: --device cuda: cuda not found" in capsys.readouterr().err
    assert not (tmp_path / "s.sock").exists()


def test_serve_verb_round_trip(weights_dir, tmp_path):
    """``python -m metagenomic_deepfri_tpu_torch.cli serve --device cpu`` in
    a subprocess answers one request over its socket as an in-process
    server on the same weights and structures does."""
    from metagenomic_deepfri_tpu_torch.serving import (AnnotationServer,
                                                       annotate_over_socket)

    fixture = structure_fixture(tmp_path / "fixture")
    for side in ("sub", "ref"):
        shutil.copytree(fixture / "structures", tmp_path / side / "structures")
    queries = dict(line.split("\n", 1) for line in
                   (fixture / "queries.faa").read_text()[1:].split("\n>"))
    queries = {k: v.replace("\n", "") for k, v in queries.items()}
    sock_dir = tempfile.mkdtemp()   # Unix socket paths are short
    sock = Path(sock_dir) / "s.sock"
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "metagenomic_deepfri_tpu_torch.cli", "serve",
         "-w", str(weights_dir), "-d", str(tmp_path / "sub" / "structures"),
         "--socket", str(sock), "-p", "mf", "-p", "cc", "-t", "2",
         "--mmseqs-max-evalue", "1e-3", "--device", "cpu"],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while True:  # until the server listens
            try:
                out = annotate_over_socket(sock, queries, timeout=120)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                assert proc.poll() is None, \
                    (tmp_path / "serve.log").read_text()
                assert time.monotonic() < deadline, "the server did not start"
                time.sleep(0.2)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
        shutil.rmtree(sock_dir, ignore_errors=True)
    ref = AnnotationServer(weights_dir,
                           databases=[tmp_path / "ref" / "structures"],
                           processing_modes=["mf", "cc"], threads=2,
                           max_eval=1e-3, device="cpu").annotate(queries)
    assert out == json.loads(json.dumps(ref))
    assert out["skipped"] == {"q_seleno": "selenocysteine"}
    assert out["results"]["q_hit_a"]["target"] == "af_0"
    assert out["results"]["q_nohit"]["network"] == "cnn"


def test_benchmark_verb(monkeypatch, capsys):
    """``benchmark`` has the JAX verb's options and defaults plus
    ``--device`` (default ``cuda``, an error without one); a tiny run on
    the CPU prints one JSON line (the engine's batch rule patched to 2
    proteins a batch)."""
    from metagenomic_deepfri_tpu_torch import bench_utils

    jax_opts = {o: p for p in jax_main.commands["benchmark"].params
                for o in p.opts}
    ours = _verb_actions("benchmark")
    assert set(ours) - set(jax_opts) == {"--device", "-h", "--help"}
    assert set(jax_opts) - set(ours) == set()
    for opt in ("--bucket", "--batches", "--n-labels"):
        assert ours[opt].default == jax_opts[opt].default, opt
    assert ours["--device"].default == "cuda"
    _no_cuda(monkeypatch)
    assert cli.main(["benchmark", "--bucket", "32"]) == 1
    assert "Error: --device cuda: cuda not found" in capsys.readouterr().err

    monkeypatch.setattr(bench_utils, "gcn_batch_size", lambda bucket: 2)
    assert cli.main(["benchmark", "--bucket", "32", "--batches", "2",
                     "--n-labels", "8", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "gcn_proteins_per_sec_per_chip"
    assert line["value"] > 0 and line["detail"]["n_proteins"] == 4
    assert line["detail"]["n_labels"] == 8
    assert line["detail"]["device"] == "cpu"


def test_device_lists_reach_the_verbs(tmp_path, monkeypatch, capsys):
    """``--device cuda:0,cuda:1``-style lists pass through ``finetune`` (with
    ``--model-parallel``) and ``serve`` to the functions that split them."""
    from metagenomic_deepfri_tpu_torch import serving, training

    seen = {}

    def fake_finetune(*args, **kwargs):
        seen["finetune"] = kwargs
        return tmp_path / "ckpt.npz"

    class FakeServer:
        def __init__(self, *args, **kwargs):
            seen["serve"] = kwargs

        def serve_unix(self, path):
            seen["socket"] = path

    monkeypatch.setattr(training, "finetune", fake_finetune)
    monkeypatch.setattr(serving, "AnnotationServer", FakeServer)
    labels = tmp_path / "labels.tsv"
    labels.write_text("p0\tGO:0000001\n")
    assert cli.main(["finetune", "-w", str(tmp_path), "-m", "mf", "-i",
                     str(tmp_path), "-l", str(labels), "-o",
                     str(tmp_path / "out"), "--device", "cpu,cpu,cpu,cpu",
                     "--model-parallel", "2"]) == 0
    assert seen["finetune"]["device"] == "cpu,cpu,cpu,cpu"
    assert seen["finetune"]["model_parallel"] == 2
    assert cli.main(["serve", "-w", str(tmp_path), "--socket",
                     str(tmp_path / "s.sock"), "--device", "cpu,cpu"]) == 0
    assert seen["serve"]["device"] == "cpu,cpu"
    for verb in ("predict-function", "finetune", "serve"):
        assert "comma-separated" in _verb_actions(verb)["--device"].help
    for verb in ("verify-weights", "benchmark"):
        assert "comma-separated" not in _verb_actions(verb)["--device"].help
