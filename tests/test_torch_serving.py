"""The port's annotation server against the JAX one, on the CPU.

The cases of ``tests/test_serving.py`` (all but the device keepalive, which
the port leaves out). Each runs the JAX ``AnnotationServer`` (no keepalive;
its engine's background warmup, which compiles bucket 512 / batch 128, is
replaced by a finished future, which changes no score) and the port's
(``device="cpu"``, where B1/B2 run their plain twins) on one weights folder
and their own copies of one structure folder. Responses must agree:

- equal ``skipped`` maps and result ids;
- equal metadata (``aligned``, ``target``, ``db``, ``identity``, the two
  coverages, ``network``);
- the same terms in the same order, except where two scores lie within
  1e-4 of each other, and except a term within 1e-4 of the 0.1 threshold,
  which may be on one side only;
- scores within one unit of the 4th decimal (1e-4 + 1e-9).
"""

import concurrent.futures
import dataclasses
import json
import shutil
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import jax

from metagenomic_deepfri_tpu.batching import engine as jax_engine
from metagenomic_deepfri_tpu.data.structures import write_ca_pdb
from metagenomic_deepfri_tpu.models.deepfri import (CNNConfig, GCNConfig,
                                                    init_cnn, init_gcn)
from metagenomic_deepfri_tpu.models.onnx_import import (export_cnn_to_onnx,
                                                        export_gcn_to_onnx)
from metagenomic_deepfri_tpu.utils import generate_config_json
import metagenomic_deepfri_tpu.serving as jax_serving
import metagenomic_deepfri_tpu_torch.serving as serving
from metagenomic_deepfri_tpu_torch.precision import \
    highest_f32_precision_active

N_LABELS = 6
GOTERMS = [f"GO:000000{i}" for i in range(N_LABELS)]
GCN_CFG = GCNConfig(n_labels=N_LABELS, lm_hidden=8, lm_layers=1,
                    embed_dim=16, gc_dims=(8,), fc_dims=(16,),
                    adj_norm="none")
CNN_CFG = CNNConfig(n_labels=N_LABELS, conv_filters=8, conv_kernels=(3,),
                    fc_dims=(16,))
AAS = list("ACDEFGHIKLMNPQRSTVWY")
SCORE_ATOL = 1e-4 + 1e-9     # one unit in the 4th decimal
META_KEYS = ("aligned", "target", "db", "identity", "query_coverage",
             "target_coverage", "network")

RNG = np.random.default_rng(3)


def _rand_seq(n):
    return "".join(RNG.choice(AAS, size=n))


def _walk(n):
    steps = RNG.normal(size=(n, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
    return np.cumsum(3.8 * steps, axis=0).astype(np.float32)


def _mutate(seq, n):
    out = list(seq)
    for pos in RNG.choice(len(seq), size=n, replace=False):
        out[pos] = RNG.choice(AAS)
    return "".join(out)


def write_weights(path: Path, gcn_cfg, cnn_cfg, seed: int, modes,
                  terms=GOTERMS) -> Path:
    """A model_config.json folder of the JAX exporters' ONNX GCN and CNN
    for each mode."""
    path.mkdir(parents=True)
    key = jax.random.PRNGKey(seed)
    for mode in modes:
        k1, k2, key = jax.random.split(key, 3)
        gname = f"DeepFRI-MERGED_GraphConv_gcd_8_fcd_16_ca_10.0_{mode}.onnx"
        cname = f"DeepCNN-MERGED_{mode}.onnx"
        export_gcn_to_onnx(init_gcn(k1, gcn_cfg), gcn_cfg, str(path / gname))
        export_cnn_to_onnx(init_cnn(k2, cnn_cfg), cnn_cfg, str(path / cname))
        for name in (gname, cname):
            with open(path / (name[:-5] + "_model_params.json"), "w") as f:
                json.dump({"goterms": terms,
                           "gonames": [f"t{i}" for i in range(len(terms))]},
                          f)
    if set(modes) == {"bp", "cc", "mf", "ec"}:
        generate_config_json(path, "1.0")
    else:
        config = {"gcn": {}, "cnn": {}, "version": "1.0"}
        for f in sorted(path.glob("*.onnx")):
            net = "gcn" if "GraphConv" in f.name else "cnn"
            config[net][f.stem.rsplit("_", 1)[1]] = str(f)
        (path / "model_config.json").write_text(json.dumps(config))
    return path


def write_structures(root: Path, seqs: dict) -> Path:
    """CA-trace PDB files, one per sequence, under ``root/structures``."""
    structures = root / "structures"
    structures.mkdir(parents=True)
    for sid, seq in seqs.items():
        write_ca_pdb(structures / f"{sid}.pdb", seq, _walk(len(seq)))
    return structures


def both_servers(root: Path, weights: Path, structures, jax_kwargs=None,
                 **kwargs):
    """(JAX server, port server) on ``weights``, each with its own copy of
    the ``structures`` folder (the database index is written beside it);
    ``jax_kwargs`` go to the JAX server alone."""
    dbs = {}
    for side in ("jax", "torch"):
        dbs[side] = []
        if structures is not None:
            dbs[side] = [root / side / "structures"]
            shutil.copytree(structures, dbs[side][0])
    done = concurrent.futures.Future()
    done.set_result(None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine.BatchedPredictor, "warmup",
                   lambda self, *args, **kw: done)
        jax_srv = jax_serving.AnnotationServer(
            weights, databases=dbs["jax"], keepalive_s=0, **kwargs,
            **(jax_kwargs or {}))
    torch_srv = serving.AnnotationServer(weights, databases=dbs["torch"],
                                         device="cpu", **kwargs)
    return jax_srv, torch_srv


def _assert_rows_match(ref_rows, got_rows, what):
    """Same terms in the same order but near-ties, scores within
    SCORE_ATOL; a term within SCORE_ATOL of the threshold may be on one side
    only. Names equal."""
    ref = {t: (s, n) for t, s, n in ref_rows}
    got = {t: (s, n) for t, s, n in got_rows}
    for term in ref.keys() ^ got.keys():
        score = (ref.get(term) or got.get(term))[0]
        assert score <= serving.SCORE_THRESHOLD + SCORE_ATOL, (what, term)
    common = [t for t, _, _ in ref_rows if t in got]
    for t in common:
        assert ref[t][1] == got[t][1], (what, t)
        assert abs(ref[t][0] - got[t][0]) <= SCORE_ATOL, (what, t)
    pos = {t: i for i, (t, _, _) in enumerate(got_rows)}
    for i, a in enumerate(common):
        for b in common[i + 1:]:
            if pos[a] > pos[b]:
                assert abs(ref[a][0] - ref[b][0]) <= SCORE_ATOL, (what, a, b)


def assert_responses_match(ref: dict, got: dict) -> None:
    """``got`` (the port's response) against ``ref`` (the JAX server's)."""
    assert got["skipped"] == ref["skipped"]
    assert set(got["results"]) == set(ref["results"])
    for qid, r in ref["results"].items():
        g = got["results"][qid]
        assert {k: g.get(k) for k in META_KEYS} == \
            {k: r.get(k) for k in META_KEYS}, qid
        assert set(g) == set(r), qid
        for key in ("scores", "propagated_scores"):
            if key not in r:
                continue
            assert set(g[key]) == set(r[key]), (qid, key)
            for mode, rows in r[key].items():
                _assert_rows_match(rows, g[key][mode], (qid, key, mode))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    weights = write_weights(root / "weights", GCN_CFG, CNN_CFG, seed=0,
                            modes=("mf", "bp", "cc", "ec"))
    seqs = {f"af_{i}": _rand_seq(60 + 10 * i) for i in range(4)}
    structures = write_structures(root / "source", seqs)
    jax_srv, torch_srv = both_servers(root, weights, structures,
                                      processing_modes=["mf", "bp"],
                                      threads=2)
    return jax_srv, torch_srv, seqs, weights


def annotate_both(setup, proteins):
    jax_srv, torch_srv = setup[:2]
    ref = jax_srv.annotate(dict(proteins))
    got = torch_srv.annotate(dict(proteins))
    assert_responses_match(ref, got)
    return got


def test_server_requires_device(setup):
    with pytest.raises(TypeError, match="device"):
        serving.AnnotationServer(setup[3], databases=[])


def test_hit_and_fallback(setup):
    seqs = setup[2]
    out = annotate_both(setup, {
        "q_hit": _mutate(seqs["af_1"], 3),
        "q_nohit": _rand_seq(45),
        "q_sec": "MKVU" + _rand_seq(30),
        "q_empty": "",
    })
    res = out["results"]
    assert out["skipped"] == {"q_sec": "selenocysteine", "q_empty": "empty"}
    assert res["q_hit"]["aligned"] is True
    assert res["q_hit"]["target"] == "af_1"
    assert res["q_hit"]["network"] == "gcn"
    assert res["q_hit"]["identity"] > 0.9
    assert res["q_nohit"]["aligned"] is False
    assert res["q_nohit"]["network"] == "cnn"
    for entry in res.values():
        assert set(entry["scores"]) == {"mf", "bp"}
        for rows in entry["scores"].values():
            scores = [s for _, s, _ in rows]
            assert all(0.1 <= s <= 1.0 for s in scores)
            assert scores == sorted(scores, reverse=True)
            assert {t for t, _, _ in rows} <= set(GOTERMS)


def test_go_propagation_in_response(setup, tmp_path):
    """With a GO DAG loaded, responses carry propagated ancestors (the
    semantics of results_propagated.tsv), on both servers alike."""
    from metagenomic_deepfri_tpu.ontology.go import GoDag as JaxGoDag
    from metagenomic_deepfri_tpu_torch.ontology.go import GoDag

    obo = tmp_path / "go.obo"
    stanzas = ["format-version: 1.2\n"]
    for i, t in enumerate(GOTERMS):
        parent = "GO:0000090" if i % 2 else "GO:0000091"
        stanzas.append(f"[Term]\nid: {t}\nname: leaf {t}\n"
                       f"is_a: {parent} ! parent\n")
    stanzas.append("[Term]\nid: GO:0000091\nname: mid parent\n"
                   "is_a: GO:0000090 ! shared parent\n")
    stanzas.append("[Term]\nid: GO:0000090\nname: shared parent\n")
    obo.write_text("\n".join(stanzas))

    jax_srv, torch_srv, seqs, _ = setup
    jax_srv._godag, jax_srv._go_anc_cache = JaxGoDag.from_obo(obo), {}
    torch_srv._godag, torch_srv._go_anc_cache = GoDag.from_obo(obo), {}
    try:
        out = annotate_both(setup, {"qp": _mutate(seqs["af_1"], 3),
                                    "qn": _rand_seq(50)})
        for entry in out["results"].values():
            for mode, rows in entry["scores"].items():
                prop = entry["propagated_scores"][mode]
                if not rows:
                    assert prop == []
                    continue
                by_term = {t: s for t, s, _ in prop}
                assert by_term["GO:0000090"] == pytest.approx(
                    max(s for _, s, _ in rows), abs=1e-4)
                assert not by_term.keys() & {t for t, _, _ in rows}
    finally:
        jax_srv._godag = torch_srv._godag = None


def test_coord_cache_reuse(setup):
    torch_srv, seqs = setup[1], setup[2]
    before = len(torch_srv._coords._data)
    annotate_both(setup, {"q": _mutate(seqs["af_2"], 2)})
    mid = len(torch_srv._coords._data)
    annotate_both(setup, {"q2": _mutate(seqs["af_2"], 3)})
    assert mid >= before
    assert len(torch_srv._coords._data) == mid  # the cached coords reused


def test_matches_batch_pipeline_scores(setup):
    """Served scores equal the port engine's batch-API scores for a hit."""
    from metagenomic_deepfri_tpu_torch.align.pairwise import \
        pairwise_against_database
    from metagenomic_deepfri_tpu_torch.bio_utils import build_align_projection

    torch_srv, seqs = setup[1], setup[2]
    q = _mutate(seqs["af_0"], 2)
    out = annotate_both(setup, {"qx": q})["results"]["qx"]
    assert out["aligned"]
    db = torch_srv.databases[0]
    target = out["target"]
    aln = pairwise_against_database(
        "qx", q, {target: torch_srv._targets[db.name][target]})
    aln.coords = torch_srv._coords.get_many(db, [(target, "qx")])[target]
    aln, proj = build_align_projection(aln)
    vec = torch_srv.engine.predict_gcn_from_coords(
        [("qx", aln.query_sequence, proj[0], proj[1])], modes=["mf"])[
            "mf"]["qx"]
    served = {t: s for t, s, _ in out["scores"]["mf"]}
    want = {t: float(v) for t, v in zip(GOTERMS, vec) if v >= 0.1}
    assert served.keys() == want.keys()
    for term, score in want.items():
        assert abs(served[term] - score) <= 0.5e-4 + 1e-9


def test_no_database_cnn_only(tmp_path):
    """A server with no databases serves CNN-only annotations."""
    weights = write_weights(tmp_path / "w", GCN_CFG, CNN_CFG, seed=5,
                            modes=("mf",))
    jax_srv, torch_srv = both_servers(tmp_path, weights, None,
                                      processing_modes=["mf"])
    q = {"q": _rand_seq(40), "r": _rand_seq(70)}
    ref = jax_srv.annotate(dict(q))
    out = torch_srv.annotate(dict(q))
    assert_responses_match(ref, out)
    assert out["results"]["q"]["aligned"] is False
    assert out["results"]["q"]["network"] == "cnn"
    assert "mf" in out["results"]["q"]["scores"]


def test_coalesced_requests_split_correctly(setup):
    """Queued requests merge into one annotate() pass and split back per
    request, id collisions included, on both servers alike. (Runs before
    any test starts a batcher thread, which would race for the queue.)"""
    seqs = setup[2]
    reqs = [
        {"q": _mutate(seqs["af_0"], 2), "extra": _rand_seq(40)},
        {"q": _rand_seq(42)},             # same id, another protein
        {"s": "MKVU" + _rand_seq(20)},    # selenocysteine skip
    ]
    got = {}
    for side, srv in zip(("jax", "torch"), setup[:2]):
        assert srv._batcher is None
        futs = [concurrent.futures.Future() for _ in reqs]
        for r, f in zip(reqs, futs):
            srv._req_q.put((dict(r), f))
        assert srv._drain_once(first_timeout=1.0) == 3
        got[side] = [f.result(timeout=5) for f in futs]
    for ref, out in zip(got["jax"], got["torch"]):
        assert_responses_match(ref, out)
    r0, r1, r2 = got["torch"]
    assert r0["results"]["q"]["target"] == "af_0"
    assert r0["results"]["extra"]["network"] == "cnn"
    assert r1["results"]["q"]["aligned"] is False
    assert set(r1["results"]) == {"q"}
    assert r2 == {"results": {}, "skipped": {"s": "selenocysteine"}}


def test_submit_single(setup):
    jax_srv, torch_srv, seqs, _ = setup
    q = {"solo": _mutate(seqs["af_1"], 2)}
    ref = jax_srv.submit(dict(q), timeout=120)
    out = torch_srv.submit(dict(q), timeout=120)
    assert_responses_match(ref, out)
    assert out["results"]["solo"]["target"] == "af_1"
    assert torch_srv._batcher.is_alive()


def test_unix_socket_roundtrip(setup):
    """The port's server over its socket against the JAX server in memory;
    two requests on one connection's worth of handler threads."""
    jax_srv, torch_srv, seqs, _ = setup
    sock_dir = tempfile.mkdtemp()   # Unix socket paths are short
    sock = Path(sock_dir) / "s.sock"
    ready = threading.Event()
    t = threading.Thread(target=torch_srv.serve_unix, args=(sock, ready),
                         daemon=True)
    t.start()
    try:
        assert ready.wait(10)
        for q in ({"q": _mutate(seqs["af_3"], 3)},
                  {"a": _rand_seq(33), "b": _mutate(seqs["af_2"], 1)}):
            out = serving.annotate_over_socket(sock, dict(q), timeout=120)
            ref = json.loads(json.dumps(jax_srv.annotate(dict(q))))
            assert_responses_match(ref, out)
        assert out["results"]["b"]["target"] == "af_2"
        bad = serving.annotate_over_socket(sock, {"x": "MK5"}, timeout=120)
        assert bad["error"].startswith("ValueError: Invalid character")
    finally:
        torch_srv.shutdown()
        t.join(timeout=10)
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert not t.is_alive()


def test_socket_burst_of_clients(setup):
    """32 clients connecting at once (more than socketserver's default
    backlog of 5) all get their own answers, equal to in-process ones."""
    torch_srv = setup[1]
    reqs = [{f"c{i}": _rand_seq(30 + i)} for i in range(32)]
    want = torch_srv.annotate({k: v for r in reqs for k, v in r.items()})
    sock_dir = tempfile.mkdtemp()
    sock = Path(sock_dir) / "s.sock"
    ready = threading.Event()
    t = threading.Thread(target=torch_srv.serve_unix, args=(sock, ready),
                         daemon=True)
    t.start()
    barrier = threading.Barrier(len(reqs))

    def client(req):
        barrier.wait(timeout=30)
        return serving.annotate_over_socket(sock, req, timeout=120)

    try:
        assert ready.wait(10)
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
            got = list(ex.map(client, reqs))
    finally:
        torch_srv.shutdown()
        t.join(timeout=10)
        shutil.rmtree(sock_dir, ignore_errors=True)
    for req, resp in zip(reqs, got):
        (qid,) = req
        assert resp == {"results": {qid: json.loads(json.dumps(
            want["results"][qid]))}, "skipped": {}}


def test_topk_server_response_identical(tmp_path):
    """The port's server, which fetches every score row dense, gives the
    responses of a JAX server with the top-256 fetch on a 600-term head
    (about half of it clears the threshold, so the JAX server re-runs its
    hits densely): more than 256 terms in a reply, each one at or above the
    threshold."""
    n_labels = 600
    terms = [f"GO:{i:07d}" for i in range(n_labels)]
    weights = write_weights(
        tmp_path / "weights", dataclasses.replace(GCN_CFG, n_labels=n_labels),
        dataclasses.replace(CNN_CFG, n_labels=n_labels), seed=8,
        modes=("mf", "bp", "cc", "ec"), terms=terms)
    base = _rand_seq(70)
    structures = write_structures(tmp_path / "source", {"af_x": base})
    queries = {"q_hit": _mutate(base, 2), "q_nohit": _rand_seq(45)}
    jax_topk, port = both_servers(tmp_path, weights, structures,
                                  jax_kwargs=dict(score_topk=256),
                                  processing_modes=["mf"], threads=2)
    assert highest_f32_precision_active()
    ref = jax_topk.annotate(dict(queries))
    got = port.annotate(dict(queries))
    assert jax_topk._dense_engine is not None  # the overflow regime was hit
    assert len(got["results"]["q_hit"]["scores"]["mf"]) > 256
    assert all(score >= serving.SCORE_THRESHOLD
               for r in got["results"].values()
               for rows in r["scores"].values() for _, score, _ in rows)
    assert_responses_match(ref, got)


def test_server_warms_request_shapes(setup, monkeypatch):
    """A server on the CPU starts no warmup. On a GPU (here: the CPU engine
    taken for one) construction starts its engine's warmup of the routes at
    bucket 512 (the JAX server's bucket): one GCN batch (every mode on the
    CPU's dense route) and one CNN batch, each of 8 proteins (a lone
    protein's batch there)."""
    from metagenomic_deepfri_tpu_torch.batching.engine import \
        BatchedPredictor

    assert setup[1]._warmup_future is None
    monkeypatch.setattr(BatchedPredictor, "on_cuda", True)
    srv = serving.AnnotationServer(setup[3], databases=[], device="cpu")
    report = srv._warmup_future.result(timeout=120)
    # a request that came first takes over the shapes not yet warmed
    assert report["shapes"] + report["skipped"] == [
        ("gcn_coords", 512, 8), ("cnn", 512, 8)]
    assert srv.engine._route("gcn_coords", 512) == ("dense",) * 4


def test_server_listens_once_warm(setup, monkeypatch, tmp_path):
    """``serve_unix`` opens its socket only once the engine's warmup has
    ended, so that the first request finds a warm engine."""
    from metagenomic_deepfri_tpu_torch.batching.engine import \
        BatchedPredictor

    release = threading.Event()
    real = BatchedPredictor._enqueue

    def held(self, *args):
        if threading.current_thread().name.startswith("engine-warmup"):
            assert release.wait(60)
        return real(self, *args)

    monkeypatch.setattr(BatchedPredictor, "_enqueue", held)
    monkeypatch.setattr(BatchedPredictor, "on_cuda", True)
    srv = serving.AnnotationServer(setup[3], databases=[],
                                   processing_modes=["mf"], device="cpu")
    sock_dir = tempfile.mkdtemp()  # Unix socket paths are short
    sock = Path(sock_dir) / "s.sock"
    ready = threading.Event()
    thread = threading.Thread(target=srv.serve_unix, args=(sock, ready),
                              daemon=True)
    thread.start()
    try:
        assert not ready.wait(0.5) and not sock.exists()
        release.set()
        assert ready.wait(60) and srv._warmup_future.done()
        out = serving.annotate_over_socket(sock, {"q": _rand_seq(40)})
        assert out["results"]["q"]["network"] == "cnn"
    finally:
        release.set()
        srv.shutdown()
        thread.join(30)
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert not thread.is_alive()


def test_server_logs_a_failed_warmup(setup, monkeypatch, caplog):
    """A warmup that raises is logged as a warning by the future's
    callback; the server answers all the same."""
    import logging

    from metagenomic_deepfri_tpu_torch.batching.engine import \
        BatchedPredictor

    real = BatchedPredictor._enqueue

    def failing(self, *args):
        if threading.current_thread().name.startswith("engine-warmup"):
            raise RuntimeError("no kernel image for this device")
        return real(self, *args)

    monkeypatch.setattr(BatchedPredictor, "_enqueue", failing)
    monkeypatch.setattr(BatchedPredictor, "on_cuda", True)
    caplog.set_level(logging.WARNING)
    srv = serving.AnnotationServer(setup[3], databases=[],
                                   processing_modes=["mf"], device="cpu")
    assert isinstance(srv._warmup_future.exception(timeout=60),
                      RuntimeError)
    deadline = time.monotonic() + 30  # the callback runs after the waiters
    while "Background engine warmup failed" not in caplog.text:
        assert time.monotonic() < deadline, caplog.text
        time.sleep(0.05)
    assert "no kernel image" in caplog.text
    out = srv.annotate({"q": _rand_seq(40)})
    assert out["results"]["q"]["network"] == "cnn"
