"""Numerical parity of the port's forward against the ONNX graph.

A copy, without jax, of ``metagenomic_deepfri_tpu/parity.py``. Every model
of a weights folder is imported (:mod:`.models.registry`) and its scores and
pre-softmax logits compared with executing the actual ONNX graph on the
host (:class:`.models.onnx_import.OnnxExecutor`) on random proteins. The
port's forward runs on an explicit ``device`` with TF32 off.

``localize_divergence`` compares the named stages of one protein, to pin a
divergence on the first stage that parts ways.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from metagenomic_deepfri_tpu_torch.models.convert import gcn_params_from_numpy
from metagenomic_deepfri_tpu_torch.models.deepfri import (
    cnn_forward_logits, forward_pass_single, forward_stages_single,
    gcn_forward_logits)
from metagenomic_deepfri_tpu_torch.models.onnx_import import (
    OnnxExecutor, cnn_stage_tensors, gcn_stage_tensors, graph_input_roles,
    normalize_graph)
from metagenomic_deepfri_tpu_torch.models.onnx_reader import load_onnx
from metagenomic_deepfri_tpu_torch.models.registry import load_model_handle
from metagenomic_deepfri_tpu_torch.ops.contact import calculate_contact_map
from metagenomic_deepfri_tpu_torch.ops.one_hot import seq2onehot, seq2tokens
from metagenomic_deepfri_tpu_torch.precision import highest_f32_precision
from metagenomic_deepfri_tpu_torch.utils import load_deepfri_config

logger = logging.getLogger(__name__)

DEFAULT_TOLERANCE = 1e-4


@dataclass
class ParityResult:
    net: str
    mode: str
    n_proteins: int
    max_abs_diff: float       # post-softmax scores
    tolerance: float
    # Pre-softmax logits, scaled: max |Δ| / (1 + |onnx_logit|). Softmax
    # saturation can hide large logit errors from the score comparison,
    # while plain |Δ| would flag float32 accumulation noise on sum-pooled
    # logits of O(10³) magnitude.
    max_logit_diff: float = float("nan")
    logit_tolerance: float = float("nan")

    @property
    def ok(self) -> bool:
        score_ok = self.max_abs_diff <= self.tolerance
        if math.isnan(self.max_logit_diff) \
                or math.isnan(self.logit_tolerance):
            return score_ok
        return score_ok and self.max_logit_diff <= self.logit_tolerance


def _random_protein(rng, min_len: int, max_len: int):
    """A random sequence and the contact map (identity diagonal) of a
    3.8 Å random-walk chain; the same draws as the JAX package's."""
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    L = int(rng.integers(min_len, max_len))
    seq = "".join(rng.choice(aas, size=L))
    steps = rng.normal(size=(L, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
    coords = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
    cmap = calculate_contact_map(coords, threshold=6.0).astype(np.float32)
    np.fill_diagonal(cmap, 1.0)
    return seq, cmap


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def check_model_parity(net: str, mode: str, model_path, params_json, *,
                       device, n_proteins: int = 10, min_len: int = 40,
                       max_len: int = 300,
                       tolerance: float = DEFAULT_TOLERANCE,
                       logit_tolerance: Optional[float] = None,
                       seed: int = 0) -> ParityResult:
    """Compare the port's forward on ``device`` with executing the ONNX
    graph on the host, for one model.

    Judged on post-softmax scores and on pre-softmax logits (read from the
    Softmax node's input in the execution trace), scaled as
    :class:`ParityResult` says.
    """
    if logit_tolerance is None:
        logit_tolerance = tolerance
    handle = load_model_handle(net, mode, model_path, params_json)
    params = gcn_params_from_numpy(handle.params, device)
    raw_graph = load_onnx(str(model_path))
    executor = OnnxExecutor(raw_graph)
    roles = graph_input_roles(raw_graph)
    softmax = next((n for n in raw_graph.nodes if n.op_type == "Softmax"),
                   None)

    rng = np.random.default_rng(seed)
    worst = 0.0
    worst_logit = 0.0
    with highest_f32_precision(), torch.inference_mode():
        for _ in range(n_proteins):
            seq, cmap = _random_protein(rng, min_len, max_len)
            feeds = {roles["S"]: seq2onehot(seq)[None]}
            if net == "gcn":
                feeds[roles["A"]] = cmap[None]
            outs, traced = executor.run(feeds, trace=True)
            scores = forward_pass_single(params, handle.config, seq,
                                         cmap if net == "gcn" else None)
            tokens = torch.from_numpy(seq2tokens(seq)[None]).to(device)
            lengths = torch.tensor([len(seq)], dtype=torch.int32,
                                   device=device)
            if net == "gcn":
                adj = torch.from_numpy(cmap[None]).to(device)
                logits = gcn_forward_logits(params, handle.config, tokens,
                                            adj, lengths)
            else:
                logits = cnn_forward_logits(params, handle.config, tokens,
                                            lengths)
            scores, logits = _to_host(scores), _to_host(logits)
            (out,) = outs
            onnx_scores = out[:, :, 0].reshape(-1)
            worst = max(worst, float(np.max(np.abs(onnx_scores - scores))))
            if softmax is not None and softmax.inputs[0] in traced:
                onnx_logits = traced[softmax.inputs[0]].reshape(logits.shape)
                scaled = np.abs(onnx_logits - logits) / \
                    (1.0 + np.abs(onnx_logits))
                worst_logit = max(worst_logit, float(np.max(scaled)))
    return ParityResult(net=net, mode=mode, n_proteins=n_proteins,
                        max_abs_diff=worst, tolerance=tolerance,
                        max_logit_diff=(worst_logit if softmax is not None
                                        else float("nan")),
                        logit_tolerance=logit_tolerance)


def localize_divergence(net: str, handle, model_path, seq: str, cmap=None,
                        *, device,
                        tolerance: float = DEFAULT_TOLERANCE) -> List[tuple]:
    """Per-stage port-vs-ONNX comparison for one protein.

    Returns ordered [(stage, max_abs_diff)]; the first entry above
    ``tolerance`` is where the two part ways. Stage names are shared by
    :func:`..models.deepfri.gcn_forward_stages` and
    :func:`..models.onnx_import.gcn_stage_tensors` (CNN likewise).
    """
    raw = load_onnx(str(model_path))
    executor = OnnxExecutor(raw)
    roles = graph_input_roles(raw)
    norm = normalize_graph(load_onnx(str(model_path)))
    stage_names = (gcn_stage_tensors(norm) if net == "gcn"
                   else cnn_stage_tensors(norm))

    feeds = {roles["S"]: seq2onehot(seq)[None]}
    if net == "gcn":
        feeds[roles["A"]] = np.asarray(cmap, np.float32)[None]
    _, traced = executor.run(feeds, trace=True)
    with highest_f32_precision(), torch.inference_mode():
        stages = forward_stages_single(
            gcn_params_from_numpy(handle.params, device), handle.config, seq,
            cmap if net == "gcn" else None)
        ours_by_stage = {k: _to_host(v) for k, v in stages.items()}
    report = []
    for stage, tensor in stage_names:
        if tensor not in traced or stage not in ours_by_stage:
            continue
        ours = ours_by_stage[stage]
        theirs = np.asarray(traced[tensor])
        if stage == "scores":
            # ONNX side is the full (B, n, 2) softmax; ours is class 0.
            theirs = theirs.reshape(ours.shape + (2,))[..., 0]
        else:
            theirs = theirs.reshape(ours.shape)
        report.append((stage, float(np.max(np.abs(ours - theirs)))))
    return report


def verify_weights(weights_dir, *, device, modes: Optional[List[str]] = None,
                   n_proteins: int = 10,
                   tolerance: float = DEFAULT_TOLERANCE,
                   logit_tolerance: Optional[float] = None,
                   seed: int = 0,
                   trace: bool = False) -> List[ParityResult]:
    """Parity-check every model in a weights folder; returns all results.

    With ``trace=True``, a failing model also gets a per-stage divergence
    report in the log (the first stage over tolerance is the culprit).
    """
    config = load_deepfri_config(weights_dir)
    results = []
    for net in ("gcn", "cnn"):
        for mode, model_path in config.get(net, {}).items():
            if modes and mode not in modes:
                continue
            params_json = str(Path(model_path).with_suffix("")) + \
                "_model_params.json"
            res = check_model_parity(net, mode, model_path, params_json,
                                     device=device, n_proteins=n_proteins,
                                     tolerance=tolerance,
                                     logit_tolerance=logit_tolerance,
                                     seed=seed)
            logger.info("parity %s/%s: scores max|Δ|=%.2e (tol %.0e), "
                        "logits max|Δ|=%.2e %s", net, mode,
                        res.max_abs_diff, tolerance, res.max_logit_diff,
                        "OK" if res.ok else "FAIL")
            if trace and not res.ok:
                handle = load_model_handle(net, mode, model_path,
                                           params_json)
                seq, cmap = _random_protein(np.random.default_rng(seed),
                                            40, 300)
                report = localize_divergence(
                    net, handle, model_path, seq,
                    cmap if net == "gcn" else None, device=device,
                    tolerance=tolerance)
                for stage, diff in report:
                    marker = " <-- diverges" if diff > tolerance else ""
                    logger.info("  stage %-8s max|Δ|=%.2e%s", stage, diff,
                                marker)
            results.append(res)
    return results
