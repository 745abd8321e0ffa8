#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure exits non-zero:

1. Device: a CUDA device is required (no CPU fallback); prints its name,
   the device count and ``nvidia-smi``'s name and power limit.
2. Build: compiles ``metagenomic_deepfri_tpu_torch/csrc/*.cu`` with nvcc
   (``graphconv.cu``: B1, B2; ``contact.cu``: B3).
3. Kernels against their plain PyTorch twins on the card, at B=4,
   L ∈ {130, 512} (sentinels and insertions) plus a near-threshold batch
   (pairs at 6 Å ± 1 ulp): degrees and contact maps exact, aggregation
   rtol 1e-5 / atol 1e-4 for D ∈ {48, 512, 1024} in float32 and bfloat16
   compute.
4. The inference slice at full published width: three GCN modes (bp 3992,
   cc 320, mf 489 terms; LSTM-LM 512×2, embed 1024, GraphConv 512×3,
   FC 1024) with seeded random weights, 96 alignment-projected proteins of
   length 40–500, through ``BatchedPredictor(device="cuda").predict_stream``
   in bfloat16 and float32. Checks ids, finiteness, range, kernel launch
   counts, and the float32 scores against the dense plain route on the card
   (atol 1e-4). Times a warm pass (proteins/s), the forward's stage shares,
   and each kernel against its twin at the main path's shapes.
5. The fine-tuning path at full published width: 48 synthetic CA-trace
   structures of length 40–500 (buckets 128/256/512), labels over the mf
   head's 489 terms, base weights exported to ONNX, then
   ``training.finetune(..., device="cuda", epochs=2, batch_size=8)`` in
   float32. Checks one B3 launch per batch, each batch's adjacency against
   the host maps (exact), finite losses, a lower loss after training on a
   fixed batch, float32 loss and gradients against float64 on the card
   (rtol below), and that the written ``.npz`` and ONNX load back with equal
   parameters. Times a training step per bucket, the LSTM's share of it,
   and B3 against its twin at B ∈ {8, 32}, L ∈ {128, 256, 512}.
6. The published model set: a weights folder for bp/cc/mf written in the
   published exporter's tf2onnx pattern, a GCN (full width, the three
   sharing one LSTM-LM and embedding) and a CNN (512 filters of widths 8
   and 16, FC 1024) per mode, with heads biased so that most scores fall
   below 0.1. ``registry.load_models`` (sharing detected),
   ``parity.verify_weights(device="cuda")`` on 2 proteins per model (scores
   and scaled logits within 1e-4), then the 96 proteins of phase 4 through
   ``predict_stream`` on the fused route (B1/B2 launches counted) and on the
   dense route's shared-trunk step (atol 1e-4 between them), 64 sequences
   without a structure hit (length 40–1000) through ``predict_cnn`` (each
   row within 1e-5 of its unpadded single-protein run on the card), and a
   ``score_topk=256`` engine held to the dense one (overflow sets equal,
   above-threshold values equal on complete rows). Times a warm pass of
   each route, the CNN, and the bp head's top-k fetch against its dense
   fetch (passes taken in turns, median of 3).
7. ``predict-function`` end to end through the port's command line on
   phase 6's weights (bp, cc, mf): a directory of 384 CA-trace PDB files
   (length 40–500) as the structure database; 256 queries copied from
   distinct structures with about 5 % substitutions and one or two short
   indels, 128 random queries (length 40–1000), two selenoproteins and two
   of length 1200 (``--max-length 1000``); the built-in search, NW
   re-alignment, coordinates, projections, the fused GCN (B1/B2), the CNN
   fallback, saved contact maps, matrices, ``results.tsv`` and GO
   propagation over a mini OBO. Run A is ``cli.main`` in this process (B1/B2
   launches counted); run B is ``python -m metagenomic_deepfri_tpu_torch.cli``
   in a subprocess with ``--skip-matrix`` (top-k fetch and the dense re-run
   of overflows). Checks: both exit 0; every hit query aligned to its own
   structure and no random one, the filtered queries absent; 3 B1 and 1 B2
   launches per mode per GCN batch; 8 hit and 8 no-hit matrix rows within
   1e-4 of the ONNX graphs run on the host by the port's numpy executor
   (the GCN fed the saved aligned contact map); run B's ``results.tsv``
   against run A's: byte-identical for every (protein, network, mode) block
   that run B took from the top-k fetch, and for the blocks it re-ran in a
   batch of another size the same rows with scores within one unit of the
   4th decimal (cuBLAS results on the card depend on the padded batch size
   in the last bits); rows for every mode, all ≥ 0.1, sorted; a larger
   ``results_propagated.tsv``. Prints both runs' wall time and
   queries/s, run A's stage profile, GCN batches and peak device memory,
   the device's busy share of run A repeated under ``torch.profiler``
   (run C), and the g++ version.
8. Prints the kernel summary, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

try:
    from metagenomic_deepfri_tpu_torch import parity, synthetic, training
    from metagenomic_deepfri_tpu_torch.batching.buckets import (
        assign_bucket, gcn_batch_size)
    from metagenomic_deepfri_tpu_torch.batching.engine import (
        BatchedPredictor, ModelHandle, _expand_topk_host, _pad_batch,
        _pad_batch_coords)
    from metagenomic_deepfri_tpu_torch.models import deepfri
    from metagenomic_deepfri_tpu_torch.models.convert import (
        gcn_params_from_numpy, gcn_params_to_numpy)
    from metagenomic_deepfri_tpu_torch.models.lstm import lstm_stack_forward
    from metagenomic_deepfri_tpu_torch.models import registry
    from metagenomic_deepfri_tpu_torch.models.registry import \
        load_model_handle
    from metagenomic_deepfri_tpu_torch.ops import _build
    from metagenomic_deepfri_tpu_torch.ops import contact
    from metagenomic_deepfri_tpu_torch.ops import graphconv as gc
    from metagenomic_deepfri_tpu_torch.ops.cmap_align import \
        aligned_contacts_from_coords
    from metagenomic_deepfri_tpu_torch.ops.one_hot import tokens2onehot
    from metagenomic_deepfri_tpu_torch.parallel import train
    from metagenomic_deepfri_tpu_torch.precision import \
        use_highest_f32_precision
except ModuleNotFoundError as err:
    raise SystemExit("chip_smoke.py runs from the root of a checkout of the "
                     f"repo: {err}") from None


SEED = 0
MODES = {"bp": 3992, "cc": 320, "mf": 489}
N_PROTEINS = 96
BATCH_CAP = 32
TIMED_BATCH = 32
BUCKETS = (128, 256, 512)
AGG_TOL = dict(rtol=1e-5, atol=1e-4)
SLICE_ATOL = 1e-4
# Phase 5: the fine-tuning path.
FT_PROTEINS = 48
FT_TERMS = 489         # the mf head of the published models
FT_EPOCHS = 2
FT_BATCH = 8
FT_LR = 1e-3
# float32 against float64 on the card: loss and every gradient leaf,
# normwise (max |g32 - g64| / max |g64|).
GRAD_RTOL = 1e-4
# Phase 6: the published model set. P6_GCN / P6_CNN override the configs'
# published defaults (empty: full width).
P6_GCN = {}
P6_CNN = {}
P6_SEQS = 64
P6_SEQ_LENGTHS = (40, 1000)
P6_VERIFY_PROTEINS = 2
# The GCN heads' kernels are scaled down so that the sum-pooled features do
# not saturate the logits; the biases then come from the scores.
P6_HEAD_SCALE = 1e-3
P6_ROUNDS = 3
TOPK = 256
SCORE_THRESHOLD = 0.1
ROUTE_ATOL = 1e-4
CNN_ATOL = 1e-5
# Phase 7: predict-function end to end on phase 6's weights.
P7_STRUCTURES = 384
P7_LENGTHS = (40, 500)
P7_HITS = 256
P7_NOHITS = 128
P7_NOHIT_LENGTHS = (40, 1000)
P7_LONG_LENGTH = 1200
P7_MAX_LENGTH = 1000
P7_OBO_TERMS = 255
P7_ORACLE = 8
P7_ORACLE_ATOL = 1e-4
# One unit of results.tsv's 4th decimal (and the rounding of two values).
P7_SCORE_ATOL = 1e-4 + 1e-9
P7_RUN_B_TIMEOUT = 600
SOURCES = {
    "graphconv_aggregate": "metagenomic_deepfri_tpu_torch/csrc/graphconv.cu",
    "contact_degrees": "metagenomic_deepfri_tpu_torch/csrc/graphconv.cu",
    "contact_map": "metagenomic_deepfri_tpu_torch/csrc/contact.cu",
}
REPLACES = {
    "contact_degrees": "metagenomic_deepfri_tpu/ops/graphconv_pallas.py:190",
    "graphconv_aggregate":
        "metagenomic_deepfri_tpu/ops/graphconv_pallas.py:275",
    "contact_map": "metagenomic_deepfri_tpu/ops/contact.py:193",
}


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    gc.reset_launch_counts()
    contact.contact_map_fused.launches = 0


def launch_counts() -> dict:
    return {"graphconv_aggregate": gc.graphconv_aggregate.launches,
            "contact_degrees": gc.contact_degrees.launches,
            "contact_map": contact.contact_map_fused.launches}


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(dev):
    """Phase 3: each kernel against its plain twin; returns max |Δ| each."""
    def on_dev(batch):
        return tuple(torch.from_numpy(a).to(dev) for a in batch)

    cases = [(f"L={L}", on_dev(synthetic.contact_batch(B=4, L=L, seed=L)))
             for L in (130, 512)]
    cases.append(("near-threshold L=512",
                  on_dev(synthetic.near_threshold_batch(B=4, L=512,
                                                        seed=SEED))))
    err = {"contact_degrees": 0.0, "graphconv_aggregate": 0.0,
           "contact_map": 0.0}
    for name, (coords, ins, lengths) in cases:
        cmap = contact.contact_map_fused(coords, lengths)
        ref = contact.batched_contact_maps(coords, lengths)
        torch.cuda.synchronize()
        d = (cmap - ref).abs().max().item()
        err["contact_map"] = max(err["contact_map"], d)
        log(f"  contact_map {name}: max|Δ|={d} (atol 0), "
            f"{int(ref.sum().item())} contacts")
        if d != 0.0:
            raise AssertionError(f"contact_map differs at {name}")
        deg = gc.contact_degrees(coords, ins, lengths)
        ref = gc.contact_degrees_ref(coords, ins, lengths)
        torch.cuda.synchronize()
        d = (deg - ref).abs().max().item()
        err["contact_degrees"] = max(err["contact_degrees"], d)
        log(f"  contact_degrees {name}: max|Δ|={d} (atol 0)")
        if d != 0.0:
            raise AssertionError(f"contact_degrees differs at {name}")
        g = torch.Generator().manual_seed(SEED)
        for D in (48, 512, 1024):
            xs = torch.randn((coords.shape[0], coords.shape[1], D),
                             generator=g).to(dev)
            for cdt in ("float32", "bfloat16"):
                out = gc.graphconv_aggregate(coords, ins, lengths, xs,
                                             compute_dtype=cdt)
                ref = gc.graphconv_aggregate_ref(coords, ins, lengths, xs,
                                                 compute_dtype=cdt)
                torch.cuda.synchronize()
                d = (out - ref).abs().max().item()
                err["graphconv_aggregate"] = max(err["graphconv_aggregate"],
                                                 d)
                log(f"  graphconv_aggregate {name} D={D} {cdt}: "
                    f"max|Δ|={d:.3g}")
                torch.testing.assert_close(out, ref, **AGG_TOL)
    return err


def make_handles(dtype: str, dev):
    handles = {}
    for i, (mode, n_labels) in enumerate(MODES.items()):
        cfg = deepfri.GCNConfig(n_labels=n_labels, compute_dtype=dtype)
        g = torch.Generator().manual_seed(SEED + i)
        handles[mode] = ModelHandle(
            "gcn", mode, cfg, deepfri.init_gcn(cfg, g, dev))
    return handles


def run_stream(engine, items, overflow_cb=None, modes=None):
    out = {m: {} for m in (modes or MODES)}

    def collect(part):
        for m, rows in part.items():
            out[m].update(rows)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = engine.predict_stream(iter(items), net="gcn_coords", modes=modes,
                              result_cb=collect, overflow_cb=overflow_cb)
    torch.cuda.synchronize()
    return out, n, time.perf_counter() - t0


def expected_batches(items) -> int:
    """Full batches per bucket at the capped steady size, plus one flush."""
    counts = {}
    for _, seq, _, _ in items:
        b = assign_bucket(len(seq))
        counts[b] = counts.get(b, 0) + 1
    return sum(-(-n // min(gcn_batch_size(b), BATCH_CAP))
               for b, n in counts.items())


def check_scores(out, items):
    """Ids complete, rows of the head's width, finite and in [0, 1]."""
    for m, n_labels in MODES.items():
        if set(out[m]) != {it[0] for it in items}:
            raise AssertionError(f"mode {m}: ids missing or extra")
        rows = np.stack([out[m][it[0]] for it in items])
        if rows.shape != (len(items), n_labels):
            raise AssertionError(f"mode {m}: shape {rows.shape}")
        if not np.isfinite(rows).all():
            raise AssertionError(f"mode {m}: non-finite scores")
        if rows.min() < 0.0 or rows.max() > 1.0:
            raise AssertionError(f"mode {m}: scores outside [0, 1]")


def max_diff(a, b) -> float:
    return max(float(np.abs(a[m][q] - b[m][q]).max())
               for m in a for q in a[m])


def stage_shares(handle, items, dev):
    """Forward time split at one bucket-512 batch: LSTM | B1+B2 | rest.

    Each part is timed alone with CUDA events on the same inputs as the
    whole forward of one mode; "rest" is the whole minus the two parts.
    """
    chunk = [it for it in items if len(it[1]) > 256][:TIMED_BATCH]
    tokens, lengths, coords, ins = (
        torch.from_numpy(a).to(dev)
        for a in _pad_batch_coords(chunk, 512, TIMED_BATCH))
    cfg = handle.config
    net = deepfri.DeepFRIGCN(cfg, handle.params)
    dtype = deepfri.compute_dtype_of(cfg)
    onehot = (tokens2onehot(tokens)
              * (torch.arange(512, device=dev)[None, :]
                 < lengths[:, None])[:, :, None])
    xs = {d: torch.randn((TIMED_BATCH, 512, d), device=dev)
          for d in (cfg.embed_dim, cfg.gc_dims[0])}

    def kernels():
        gc.contact_degrees(coords, ins, lengths)
        gc.graphconv_aggregate(coords, ins, lengths, xs[cfg.embed_dim],
                               compute_dtype=cfg.compute_dtype)
        for d in cfg.gc_dims[:-1]:
            gc.graphconv_aggregate(coords, ins, lengths, xs[d],
                                   compute_dtype=cfg.compute_dtype)

    with torch.inference_mode():
        whole = cuda_ms(lambda: net(tokens, coords, ins, lengths), iters=5,
                        warmup=1)
        lm = cuda_ms(lambda: lstm_stack_forward(
            handle.params["lm"], onehot, lengths, compute_dtype=dtype),
            iters=5, warmup=1)
        kern = cuda_ms(kernels, iters=5, warmup=1)
    return {"forward_ms": whole, "lstm_ms": lm, "kernels_ms": kern,
            "lstm_share": lm / whole, "kernels_share": kern / whole,
            "rest_share": 1.0 - (lm + kern) / whole}


def kernel_times(dev):
    """Each kernel and its twin at the main path's shapes (B=TIMED_BATCH)."""
    rows = []
    for L in BUCKETS:
        coords, ins, lengths = (
            torch.from_numpy(a).to(dev)
            for a in synthetic.contact_batch(B=TIMED_BATCH, L=L, seed=L))
        rows.append({
            "kernel": "contact_degrees", "bucket": L, "D": None,
            "dtype": "float32",
            "ms": cuda_ms(lambda: gc.contact_degrees(coords, ins, lengths)),
            "plain_ms": cuda_ms(
                lambda: gc.contact_degrees_ref(coords, ins, lengths))})
        for D in (1024, 512):
            xs = torch.randn((TIMED_BATCH, L, D), device=dev)
            for cdt in ("bfloat16", "float32"):
                rows.append({
                    "kernel": "graphconv_aggregate", "bucket": L, "D": D,
                    "dtype": cdt,
                    "ms": cuda_ms(lambda: gc.graphconv_aggregate(
                        coords, ins, lengths, xs, compute_dtype=cdt)),
                    "plain_ms": cuda_ms(lambda: gc.graphconv_aggregate_ref(
                        coords, ins, lengths, xs, compute_dtype=cdt))})
    return rows


def kernel_device_ms(fn, name: str, iters: int = 10) -> float | None:
    """Mean device time of the CUDA kernel ``name`` over ``iters`` calls of
    ``fn``, from ``torch.profiler``; None if the trace shows no such
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    if not hits:
        return None
    return (sum(e.device_time_total for e in hits)
            / sum(e.count for e in hits) / 1e3)


def contact_map_times(dev):
    """B3 and its twin at the fine-tuning path's shapes (B=8) and B=32:
    CUDA-event time per call (host launch included) and the kernel's own
    device time."""
    rows = []
    for B in (FT_BATCH, TIMED_BATCH):
        for L in BUCKETS:
            coords, _, lengths = (
                torch.from_numpy(a).to(dev)
                for a in synthetic.contact_batch(B=B, L=L, seed=L + B))

            def kernel():
                return contact.contact_map_fused(coords, lengths)

            rows.append({
                "kernel": "contact_map", "B": B, "bucket": L,
                "ms": cuda_ms(kernel),
                "plain_ms": cuda_ms(lambda: contact.batched_contact_maps(
                    coords, lengths)),
                "device_ms": kernel_device_ms(kernel, "contact_map_kernel")})
    return rows


def normwise_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|, in float64."""
    ref = ref.double()
    return ((got.double() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-300)).item()


def loss_and_grads(params_np, config, batch, dev):
    """gcn_loss and its gradients at ``params_np`` in the config's dtype."""
    dtype = deepfri.compute_dtype_of(config)
    params = gcn_params_from_numpy(params_np, dev, dtype, requires_grad=True)
    tokens, adj, lengths, labels = batch
    loss = train.gcn_loss(params, config, tokens, adj.to(dtype), lengths,
                          labels)
    grads = torch.autograd.grad(loss, train.param_leaves(params))
    return [loss.detach()] + list(grads)


def precision_check(params_np, config, batch, dev):
    """Worst normwise error of float32 (and, reported only, TF32) loss and
    gradients against float64, all on the card."""
    ref = loss_and_grads(params_np, dataclasses.replace(
        config, compute_dtype="float64"), batch, dev)
    use_highest_f32_precision()
    f32 = loss_and_grads(params_np, config, batch, dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = loss_and_grads(params_np, config, batch, dev)
    finally:
        use_highest_f32_precision()
    return {name: max(normwise_err(g, r) for g, r in zip(got, ref,
                                                         strict=True))
            for name, got in (("float32", f32), ("tf32", tf32))}


def step_times(params_np, config, batches, dev):
    """Seconds per training step per bucket and the LSTM-LM's forward and
    backward alone on the same batch: host clock around each synchronised
    call, the two taken in turns after one warm call each, median of 5."""
    rows = []
    for bucket, batch in sorted(batches.items()):
        state = train.init_train_state(config, FT_LR, dev, params=params_np)
        step = train.make_train_step(config)
        tokens, _, lengths, _ = batch
        lm = gcn_params_from_numpy(params_np["lm"], dev, requires_grad=True)
        valid = (torch.arange(bucket, device=dev)[None, :]
                 < lengths[:, None])
        onehot = tokens2onehot(tokens) * valid[:, :, None]

        def train_step():
            nonlocal state
            state, _ = step(state, *batch)

        def lstm_fwd_bwd():
            lstm_stack_forward(lm, onehot, lengths).sum().backward()

        fns = {"step_s": train_step, "lstm_s": lstm_fwd_bwd}
        samples = {name: [] for name in fns}
        for rep in range(6):
            for name, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if rep:  # the first round warms up
                    samples[name].append(time.perf_counter() - t0)
        secs = {name: float(np.median(v)) for name, v in samples.items()}
        rows.append({"bucket": bucket, "batch": FT_BATCH, **secs,
                     "lstm_share": secs["lstm_s"] / secs["step_s"]})
    return rows


def assert_trees_equal(a, b, what: str) -> None:
    fa, fb = registry._flatten(a), registry._flatten(b)
    if fa.keys() != fb.keys() or any(
            fa[k].shape != fb[k].shape or not np.array_equal(fa[k], fb[k])
            for k in fa):
        raise AssertionError(f"{what}: parameters differ")


def phase_finetune(dev, smi):
    """Phase 5: fine-tune the full-width mf GCN; returns B3's launches."""
    # The ONNX graphs consume the adjacency as fed (as the published ones
    # do), so the imported config has no normalisation.
    cfg = deepfri.GCNConfig(n_labels=FT_TERMS, adj_norm="none")
    terms = synthetic.goterms(FT_TERMS)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        structures, labels_path = synthetic.write_training_corpus(
            tmp, FT_PROTEINS, terms, seed=SEED)
        base = deepfri.init_gcn(cfg, torch.Generator().manual_seed(SEED),
                                "cpu")
        weights = synthetic.write_gcn_weights(tmp / "weights", cfg, base,
                                              terms)
        base_handle = load_model_handle(
            "gcn", "mf", next(weights.glob("*.onnx")),
            next(weights.glob("*_model_params.json")))
        if base_handle.config != cfg:
            raise AssertionError(f"base config {base_handle.config}")

        dataset = training.FineTuneDataset(
            structures, training.load_labels(labels_path, terms))
        plan = list(dataset.batch_plan(FT_BATCH, np.random.default_rng(SEED)))
        counts = {}
        for bucket, _ in plan:
            counts[bucket] = counts.get(bucket, 0) + 1
        log(f"phase 5: {len(dataset.items)} structures, {len(plan)} batches "
            f"an epoch {counts}, {FT_EPOCHS} epochs, batch {FT_BATCH}")

        # Each batch's adjacency (B3 on the card) against the host maps.
        batches = {}
        for (bucket, chunk), batch in zip(plan, dataset.iter_batches(
                FT_BATCH, np.random.default_rng(SEED), dev), strict=True):
            host = np.zeros((len(chunk), bucket, bucket), np.float32)
            for j, idx in enumerate(chunk):
                xyz = dataset.items[idx][1]
                host[j, :len(xyz), :len(xyz)] = contact.calculate_contact_map(
                    xyz, threshold=dataset.contact_threshold)
            if not np.array_equal(batch[1].cpu().numpy(), host):
                raise AssertionError(f"bucket {bucket}: B3 adjacency differs "
                                     "from the host contact maps")
            batches.setdefault(bucket, batch)
        log(f"  adjacency of all {len(plan)} batches equals the host maps")

        losses = []
        reset_launch_counts()
        t0 = time.perf_counter()
        ckpt = training.finetune(
            weights, "mf", structures, labels_path, tmp / "out",
            device=dev, epochs=FT_EPOCHS, learning_rate=FT_LR,
            batch_size=FT_BATCH, seed=SEED,
            on_step=lambda i, loss: losses.append(loss))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts()
        want = FT_EPOCHS * len(plan)
        losses = torch.stack(losses).cpu().numpy()
        log(f"  finetune: {secs:.2f} s, {len(losses)} steps, launches "
            f"{launches}, losses {losses[0]:.5f} … {losses[-1]:.5f}")
        if launches["contact_map"] != want or len(losses) != want:
            raise AssertionError(f"expected {want} steps and B3 launches")
        if not np.isfinite(losses).all():
            raise AssertionError("non-finite training loss")

        out = ckpt.parent
        params_json = next(out.glob("*_model_params.json"))
        tuned = load_model_handle("gcn", "mf", ckpt, params_json)
        reexport = load_model_handle("gcn", "mf", next(out.glob("*.onnx")),
                                     params_json)
        if tuned.config != cfg or reexport.config != cfg:
            raise AssertionError("fine-tuned config differs from the base")
        assert_trees_equal(tuned.params, reexport.params, ".npz vs ONNX")
        log("  .npz and ONNX re-export load back with equal parameters")

        fixed = batches[max(batches)]
        with torch.no_grad():
            before, after = (train.gcn_loss(
                gcn_params_from_numpy(h.params, dev), cfg, *fixed).item()
                for h in (base_handle, tuned))
        log(f"  fixed bucket-{max(batches)} batch: loss {before:.6f} before, "
            f"{after:.6f} after")
        if not after < before:
            raise AssertionError("fine-tuning did not lower the loss")

        errs = precision_check(base_handle.params, cfg, fixed, dev)
        log(f"  loss and gradients vs float64 on the card (normwise, worst "
            f"leaf): float32 {errs['float32']:.3g} (rtol {GRAD_RTOL}), "
            f"TF32 {errs['tf32']:.3g} (reported, not asserted)")
        if not errs["float32"] <= GRAD_RTOL:
            raise AssertionError("float32 gradients differ from float64")

        for row in step_times(base_handle.params, cfg, batches, dev):
            log(f"  train step {json.dumps(row)} on {smi}")
    return launches["contact_map"]


def expect_launches(got: dict, want: dict, what: str) -> None:
    log(f"  {what}: launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"{what}: kernel launch counts differ")


def no_hit_sequences(n: int, seed: int) -> list:
    """``n`` (id, sequence) CNN items, lengths uniform in P6_SEQ_LENGTHS."""
    rng = np.random.default_rng(seed)
    lo, hi = P6_SEQ_LENGTHS
    return [(f"s{i}", "".join(rng.choice(list(synthetic.AMINO_ACIDS),
                                         size=int(rng.integers(lo, hi + 1)))))
            for i in range(n)]


def near_threshold_terms(n_labels: int) -> int:
    """Terms whose median score sits on the threshold: 2·K for a head that
    top-k compacts (so some proteins overflow and some do not), an eighth
    of the head otherwise."""
    return 2 * TOPK if n_labels > 2 * TOPK else n_labels // 8


def calibrate_heads(handles: dict, logits) -> None:
    """Set each zero-bias head's bias from its logits over a catalogue
    (``logits(handle)``: (P, n_labels, 2), computed on the card), as
    ``synthetic.threshold_head_bias`` says."""
    for i, h in enumerate(handles.values()):
        out = logits(h)
        h.params["head"]["bias"] = synthetic.threshold_head_bias(
            out[..., 0] - out[..., 1], SCORE_THRESHOLD,
            near_threshold_terms(h.config.n_labels), seed=SEED + i)


def catalogue_logits(dev, items, seqs):
    """Functions of a handle giving its (P, n_labels, 2) logits over the
    GCN catalogue (dense route, bucket 512) or the CNN one (bucket 1024)."""
    gcn_batches = []
    for start in range(0, len(items), BATCH_CAP):
        chunk = items[start:start + BATCH_CAP]
        tokens, lengths, coords, ins = (
            torch.from_numpy(a).to(dev)
            for a in _pad_batch_coords(chunk, 512, len(chunk)))
        gcn_batches.append((tokens, aligned_contacts_from_coords(
            coords, ins, lengths), lengths))
    cnn_batch = tuple(torch.from_numpy(a).to(dev)
                      for a in _pad_batch(seqs, 1024, len(seqs)))

    def gcn(h):
        params = gcn_params_from_numpy(h.params, dev)
        with torch.inference_mode():
            return torch.cat([deepfri.gcn_forward_logits(
                params, h.config, *b) for b in gcn_batches]).cpu().numpy()

    def cnn(h):
        with torch.inference_mode():
            return deepfri.cnn_forward_logits(
                gcn_params_from_numpy(h.params, dev), h.config,
                *cnn_batch).cpu().numpy()

    return gcn, cnn


def model_set_params(dev, items, seqs):
    """{mode: GCN handle}, {mode: CNN handle}: numpy trees, the GCNs sharing
    bp's LSTM-LM and embeddings, every head calibrated on the card."""
    gcn, cnn = {}, {}
    for i, (mode, n_labels) in enumerate(MODES.items()):
        gcfg = deepfri.GCNConfig(n_labels=n_labels, adj_norm="none",
                                 **P6_GCN)
        gp = gcn_params_to_numpy(deepfri.init_gcn(
            gcfg, torch.Generator().manual_seed(SEED + 10 + i), "cpu"))
        gp["head"]["kernel"] *= P6_HEAD_SCALE
        if gcn:
            for k in ("lm", "lm_embed", "aa_embed"):
                gp[k] = gcn["bp"].params[k]
        gcn[mode] = ModelHandle("gcn", mode, gcfg, gp)
        ccfg = deepfri.CNNConfig(n_labels=n_labels, **P6_CNN)
        cnn[mode] = ModelHandle("cnn", mode, ccfg, gcn_params_to_numpy(
            deepfri.init_cnn(ccfg, torch.Generator().manual_seed(
                SEED + 20 + i), "cpu")))
    gcn_logits, cnn_logits = catalogue_logits(dev, items, seqs)
    calibrate_heads(gcn, gcn_logits)
    calibrate_heads(cnn, cnn_logits)
    return gcn, cnn


def timed(fn):
    """(result, seconds) of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fetch_times(dev, reps: int = 50) -> dict:
    """Milliseconds to bring one batch of bp scores (BATCH_CAP × 3992, on
    the card) to dense host rows: the dense fetch against top-k on the card
    plus the (value, index) fetch and the host expansion. Host clock
    around synchronised calls, median of ``reps``, taken in turns."""
    n_labels = MODES["bp"]
    scores = torch.rand((BATCH_CAP, n_labels), device=dev)

    def dense():
        return scores.cpu().numpy()

    def topk():
        vals, idx = torch.topk(scores, TOPK, dim=-1, sorted=True)
        return _expand_topk_host((vals.cpu().numpy(),
                                  idx.to(torch.int32).cpu().numpy()),
                                 n_labels, SCORE_THRESHOLD)

    samples = {"dense_fetch_ms": [], "topk_fetch_ms": []}
    for rep in range(reps + 1):
        for name, fn in (("dense_fetch_ms", dense), ("topk_fetch_ms", topk)):
            _, secs = timed(fn)
            if rep:
                samples[name].append(1e3 * secs)
    return {name: float(np.median(v)) for name, v in samples.items()}


def phase_models(dev, smi, items, weights):
    """Phase 6: the published model set, written to the folder ``weights``
    (phase 7 reads it again), through the whole engine; every check raises
    on failure."""
    seqs = no_hit_sequences(P6_SEQS, SEED)
    gcn_np, cnn_np = model_set_params(dev, items, seqs)
    synthetic.write_model_set(
        weights,
        {m: (h.config, h.params, synthetic.goterms(h.config.n_labels))
         for m, h in gcn_np.items()},
        {m: (h.config, h.params, synthetic.goterms(h.config.n_labels))
         for m, h in cnn_np.items()})
    t0 = time.perf_counter()
    gcn_h, cnn_h, _ = registry.load_models(weights, list(MODES))
    log(f"phase 6: load_models {time.perf_counter() - t0:.2f} s: GCN "
        f"{sorted(gcn_h)}, CNN {sorted(cnn_h)}")
    for m in MODES:
        if (gcn_h[m].config != gcn_np[m].config
                or cnn_h[m].config != cnn_np[m].config):
            raise AssertionError(f"{m}: imported config differs")
        assert_trees_equal(gcn_h[m].params, gcn_np[m].params, f"gcn/{m}")
        assert_trees_equal(cnn_h[m].params, cnn_np[m].params, f"cnn/{m}")
    t0 = time.perf_counter()
    results = parity.verify_weights(weights, device=dev,
                                    n_proteins=P6_VERIFY_PROTEINS)
    log(f"  verify_weights ({time.perf_counter() - t0:.2f} s, "
        f"{P6_VERIFY_PROTEINS} proteins a model):")
    for r in results:
        log(f"    {r.net}/{r.mode}: scores max|Δ|={r.max_abs_diff:.3g}, "
            f"scaled logits max|Δ|={r.max_logit_diff:.3g} (tol "
            f"{r.tolerance}) {'ok' if r.ok else 'FAIL'}")
    if len(results) != 2 * len(MODES) or not all(r.ok for r in results):
        raise AssertionError("verify_weights: a model exceeds tolerance")

    fused = BatchedPredictor(gcn_h, cnn_h, device=dev, batch_cap=BATCH_CAP)
    dense = BatchedPredictor(gcn_h, cnn_h, device=dev, batch_cap=BATCH_CAP,
                             spmm="dense")
    topk = BatchedPredictor(gcn_h, device=dev, batch_cap=BATCH_CAP,
                            spmm="dense", score_topk=TOPK)
    shared = sorted(dense._gcn_shared[0]) if dense._gcn_shared else []
    log(f"  shared trunk: {shared}")
    if shared != ["aa_embed", "lm", "lm_embed"] or not dense._multi_key(
            list(MODES)):
        raise AssertionError("the shared LSTM-LM and embedding not detected")

    n_batches = expected_batches(items)
    reset_launch_counts()
    fused_out, _, _ = run_stream(fused, items)
    expect_launches(launch_counts(), {
        "contact_degrees": len(MODES) * n_batches,
        "graphconv_aggregate": 3 * len(MODES) * n_batches,
        "contact_map": 0}, "fused route")
    launches = launch_counts()
    reset_launch_counts()
    dense_out, _, _ = run_stream(dense, items)
    expect_launches(launch_counts(), {k: 0 for k in launches},
                    "dense multi-mode route")
    for out in (fused_out, dense_out):
        check_scores(out, items)
    route_diff = max_diff(fused_out, dense_out)
    log(f"  fused per mode vs dense multi-mode: max|Δ|={route_diff:.3g} "
        f"(atol {ROUTE_ATOL})")
    if not route_diff <= ROUTE_ATOL:
        raise AssertionError("the two GCN routes differ")

    reset_launch_counts()
    cnn_out, _ = timed(lambda: fused.predict_cnn(seqs))
    expect_launches(launch_counts(), {k: 0 for k in launches}, "CNN")
    check_scores(cnn_out, seqs)
    cnn_diff = 0.0
    with torch.inference_mode():
        for m, h in cnn_h.items():
            params = gcn_params_from_numpy(h.params, dev)
            for qid, seq in seqs:
                single = deepfri.forward_pass_single(params, h.config, seq)
                cnn_diff = max(cnn_diff, float(np.abs(
                    single.cpu().numpy() - cnn_out[m][qid]).max()))
    log(f"  CNN batch vs unpadded single runs: max|Δ|={cnn_diff:.3g} "
        f"(atol {CNN_ATOL}), {len(seqs)} sequences")
    if not cnn_diff <= CNN_ATOL:
        raise AssertionError("CNN batch rows differ from unpadded runs")

    flagged = set()
    topk_out, _, _ = run_stream(topk, items, overflow_cb=lambda m, q: (
        flagged.update(q) if m == "bp" else None))
    want = {q for q, row in dense_out["bp"].items()
            if (row >= SCORE_THRESHOLD).sum() >= TOPK}
    topk_diff = max((float(np.abs(topk_out["bp"][q][row >= SCORE_THRESHOLD]
                                  - row[row >= SCORE_THRESHOLD]).max(
                                      initial=0.0))
                     for q, row in dense_out["bp"].items()
                     if q not in flagged), default=0.0)
    above = [int((r >= SCORE_THRESHOLD).sum())
             for r in dense_out["bp"].values()]
    log(f"  top-k {TOPK} (bp, {MODES['bp']} terms): {len(flagged)} rows "
        f"overflowed, {len(items) - len(flagged)} complete; terms ≥ "
        f"{SCORE_THRESHOLD} a row: {min(above)}–{max(above)}; complete rows "
        f"vs dense: max|Δ|={topk_diff:.3g}")
    if flagged != want or not 0 < len(flagged) < len(items):
        raise AssertionError("top-k overflow set differs from the dense rows")
    if not topk_diff <= 1e-6:
        raise AssertionError("top-k rows differ from the dense rows")

    def per_mode(eng):
        # one request per mode: the dense route then runs no shared step
        return sum(run_stream(eng, items, modes=[m])[2] for m in MODES)

    passes = {
        "fused_per_mode": lambda: run_stream(fused, items)[2],
        "dense_per_mode": lambda: per_mode(dense),
        "dense_multimode": lambda: run_stream(dense, items)[2],
        "dense_multimode_topk": lambda: run_stream(topk, items)[2],
        "cnn": lambda: timed(lambda: fused.predict_cnn(seqs))[1]}
    samples = {name: [] for name in passes}
    for _ in range(P6_ROUNDS):
        for name, fn in passes.items():
            samples[name].append(fn())
    rates = {f"{name}_proteins_per_s":
             (len(seqs) if name == "cnn" else len(items)) / float(
                 np.median(secs)) for name, secs in samples.items()}
    log(f"  warm passes, median of {P6_ROUNDS} taken in turns "
        f"({len(items)} proteins, {len(MODES)} modes; CNN {len(seqs)} "
        f"sequences, {len(MODES)} modes): {json.dumps(rates)} on {smi}")
    log(f"  bp fetch of one batch ({BATCH_CAP} × {MODES['bp']}): "
        f"{json.dumps(fetch_times(dev))} on {smi}")

def mini_obo(path: Path, n_terms: int) -> Path:
    """A GO OBO over the synthetic terms: GO:i is_a GO:(i-1)//2 for the
    first ``n_terms`` (a binary tree), so every predicted term among them
    has ancestors to propagate to."""
    lines = ["format-version: 1.2", ""]
    for i, term in enumerate(synthetic.goterms(n_terms)):
        lines += ["[Term]", f"id: {term}", f"name: term {term}"]
        if i:
            lines.append(f"is_a: GO:{(i - 1) // 2:07d} ! parent")
        lines.append("")
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return path


def predict_inputs(root: Path):
    """Phase 7's structure directory, query FASTA and OBO under ``root``.
    Returns ``(structures, queries_path, obo, hits {qid: source id},
    no_hits [qid], dropped [qid])``."""
    structures = root / "structures"
    db = synthetic.write_structure_db(structures, P7_STRUCTURES, SEED + 70,
                                      *P7_LENGTHS)
    rng = np.random.default_rng(SEED + 71)
    sources = rng.choice(sorted(db), size=P7_HITS, replace=False)
    queries, hits = {}, {}
    for i, sid in enumerate(sources):
        hits[f"hit{i}"] = str(sid)
        queries[f"hit{i}"] = synthetic.hit_query(rng, db[sid])
    aas = list(synthetic.AMINO_ACIDS)
    lo, hi = P7_NOHIT_LENGTHS
    no_hits = [f"nohit{i}" for i in range(P7_NOHITS)]
    for qid in no_hits:
        queries[qid] = "".join(rng.choice(
            aas, size=int(rng.integers(lo, hi + 1))))
    dropped = []
    for i in range(2):
        seq = list(rng.choice(aas, size=200))
        seq[int(rng.integers(20, 180))] = "U"
        queries[f"seleno{i}"] = "".join(seq)
        queries[f"long{i}"] = "".join(rng.choice(aas, size=P7_LONG_LENGTH))
        dropped += [f"seleno{i}", f"long{i}"]
    order = list(queries)
    rng.shuffle(order)
    queries_path = root / "queries.faa"
    queries_path.write_text("".join(f">{q}\n{queries[q]}\n" for q in order),
                            encoding="utf-8")
    obo = mini_obo(root / "go-mini.obo", P7_OBO_TERMS)
    return structures, queries_path, obo, hits, no_hits, dropped


def read_tsv(path: Path):
    lines = path.read_text(encoding="utf-8").splitlines()
    return lines[0].split("\t"), [ln.split("\t") for ln in lines[1:]]


def matrix_rows(path: Path, qids) -> dict:
    """{qid: (network, float32 scores)} of a prediction matrix's rows."""
    out = {}
    with open(path, encoding="utf-8") as f:
        next(f)
        for line in f:
            qid, net, rest = line.rstrip("\n").split("\t", 2)
            if qid in qids:
                out[qid] = (net, np.asarray(rest.split("\t"), np.float32))
    return out


def onnx_oracle(weights: Path, out: Path, hits, no_hits) -> float:
    """Check 4: each prediction-matrix row of ``hits``/``no_hits`` against
    the ONNX graph run on the host by the port's numpy executor (GCN fed
    the saved aligned contact map, CNN the sequence alone); max |Δ|."""
    from metagenomic_deepfri_tpu_torch.data.fasta import load_fasta_as_dict
    from metagenomic_deepfri_tpu_torch.models.onnx_import import (
        OnnxExecutor, graph_input_roles)
    from metagenomic_deepfri_tpu_torch.models.onnx_reader import load_onnx
    from metagenomic_deepfri_tpu_torch.ops.one_hot import seq2onehot
    from metagenomic_deepfri_tpu_torch.utils import load_deepfri_config

    config = load_deepfri_config(weights)
    seqs = load_fasta_as_dict(out.parent / "queries.faa")
    worst = 0.0
    for mode in MODES:
        rows = matrix_rows(out / f"prediction_matrix_{mode}.tsv",
                           set(hits) | set(no_hits))
        for net, qids in (("gcn", hits), ("cnn", no_hits)):
            graph = load_onnx(config[net][mode])
            executor, roles = OnnxExecutor(graph), graph_input_roles(graph)
            for qid in qids:
                feeds = {roles["S"]: seq2onehot(seqs[qid])[None]}
                if net == "gcn":
                    feeds[roles["A"]] = np.load(
                        out / "contact_maps" / f"{qid}.npy").astype(
                            np.float32)[None]
                (onnx_out,) = executor.run(feeds)
                got_net, row = rows[qid]
                if got_net != net:
                    raise AssertionError(f"{qid}: {got_net} row, want {net}")
                worst = max(worst, float(np.abs(
                    onnx_out[:, :, 0].reshape(-1) - row).max()))
    return worst


MODE_NAMES = {"bp": "GO Biological Process", "cc": "GO Cellular Component",
              "mf": "GO Molecular Function"}


def rerun_groups(out: Path) -> set:
    """(protein, network, mode name) of the rows that run B's top-k fetch
    overflows (``TOPK`` or more scores ≥ the threshold in run A's dense
    matrix, for heads wider than 2·``TOPK``): the pipeline re-runs them in
    a batch of another size."""
    groups = set()
    for mode, n_labels in MODES.items():
        if n_labels <= 2 * TOPK:
            continue
        with open(out / f"prediction_matrix_{mode}.tsv",
                  encoding="utf-8") as f:
            next(f)
            for line in f:
                qid, net, rest = line.rstrip("\n").split("\t", 2)
                scores = np.asarray(rest.split("\t"), np.float32)
                if (scores >= SCORE_THRESHOLD).sum() >= TOPK:
                    groups.add((qid, net, MODE_NAMES[mode]))
    return groups


def compare_runs(out_a: Path, out_b: Path, rerun: set) -> dict:
    """Check 5: run B's ``results.tsv`` against run A's. The blocks of
    (protein, network, mode) come in the same order; a block run B took
    from the top-k fetch of the same batch is byte-identical; a block it
    re-ran densely in a batch of another size (``rerun``) has the same
    rows but for scores within one unit of the 4th decimal, terms within
    that of the threshold, and the order of near-ties."""
    def blocks(path):
        header, rows = read_tsv(path)
        out = {}
        for r in rows:
            out.setdefault(tuple(r[:3]), []).append(r)
        return header, out

    (ha, a), (hb, b) = blocks(out_a / "results.tsv"), blocks(
        out_b / "results.tsv")
    if ha != hb or list(a) != list(b):
        raise AssertionError("results.tsv: header or blocks differ")
    stats = {"blocks": len(a), "rerun_blocks": 0, "rerun_rows_differing": 0,
             "rerun_max_score_delta": 0.0}
    for key, rows_a in a.items():
        rows_b = b[key]
        if key not in rerun:
            if rows_a != rows_b:
                raise AssertionError(f"results.tsv differs at {key}, which "
                                     "was not re-run")
            continue
        stats["rerun_blocks"] += 1
        stats["rerun_rows_differing"] += sum(x != y for x, y in zip(
            rows_a, rows_b)) + abs(len(rows_a) - len(rows_b))
        by_a = {r[3]: r for r in rows_a}
        by_b = {r[3]: r for r in rows_b}
        for term in by_a.keys() | by_b.keys():
            ra, rb = by_a.get(term), by_b.get(term)
            if ra is None or rb is None:
                if float((ra or rb)[4]) > SCORE_THRESHOLD + P7_SCORE_ATOL:
                    raise AssertionError(f"{key} {term}: row on one side")
                continue
            delta = abs(float(ra[4]) - float(rb[4]))
            stats["rerun_max_score_delta"] = max(
                stats["rerun_max_score_delta"], delta)
            if ra[:4] + ra[5:] != rb[:4] + rb[5:] or delta > P7_SCORE_ATOL:
                raise AssertionError(f"{key} {term}: {ra} vs {rb}")
    return stats


def check_results(out: Path, n_modes: int) -> int:
    """Check 6: rows for every mode, all ≥ the threshold, each (protein,
    network, mode) block sorted by score; then check 7. Returns the rows."""
    header, rows = read_tsv(out / "results.tsv")
    if {r[2] for r in rows} != {MODE_NAMES[m] for m in MODES} or \
            len(MODE_NAMES) != n_modes:
        raise AssertionError("results.tsv lacks rows of a mode")
    scores = [float(r[4]) for r in rows]
    if min(scores) < SCORE_THRESHOLD:
        raise AssertionError("results.tsv holds a score below the threshold")
    for prev, cur, ps, cs in zip(rows, rows[1:], scores, scores[1:]):
        if prev[:3] == cur[:3] and cs > ps:
            raise AssertionError(f"results.tsv unsorted at {cur[:4]}")
    p_header, p_rows = read_tsv(out / "results_propagated.tsv")
    if p_header != header + ["propagated"] or len(p_rows) < len(rows) or \
            not any(r[-1] == "True" for r in p_rows):
        raise AssertionError("results_propagated.tsv is incomplete")
    return len(rows)


def phase_predict(dev, smi, weights: Path, root: Path, device_arg: str):
    """Phase 7: ``predict-function`` end to end through the port's command
    line, in this process (run A) and in a subprocess (run B,
    ``--skip-matrix``). Returns run A's kernel launches."""
    from metagenomic_deepfri_tpu_torch import cli, profiling
    from metagenomic_deepfri_tpu_torch.native import build as native

    log(f"phase 7: g++ {native.compiler_version()}")
    t0 = time.perf_counter()
    structures, queries, obo, hits, no_hits, dropped = predict_inputs(root)
    n_queries = len(hits) + len(no_hits) + len(dropped)
    log(f"  inputs {time.perf_counter() - t0:.2f} s: {P7_STRUCTURES} "
        f"structures, {len(hits)} hit + {len(no_hits)} no-hit queries, "
        f"{len(dropped)} filtered (selenoprotein, > {P7_MAX_LENGTH} aa)")
    threads = min(16, os.cpu_count() or 1)
    argv = ["predict-function", "-i", str(queries), "-d", str(structures),
            "-w", str(weights), "--skip-pdb", "--device", device_arg,
            "-p", "bp", "-p", "cc", "-p", "mf", "--propagate-go-terms",
            "--obo-path", str(obo), "--max-length", str(P7_MAX_LENGTH),
            "-t", str(threads)]

    batches = []
    real_run_batch = BatchedPredictor._run_batch

    def spy(self, bucket, chunk, batch, modes, net="gcn_coords",
            overflow_cb=None):
        batches.append((net, bucket, batch, len(chunk)))
        return real_run_batch(self, bucket, chunk, batch, modes, net,
                              overflow_cb)

    out_a, out_b = root / "run_a", root / "run_b"
    profiling.reset()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    BatchedPredictor._run_batch = spy
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-o", str(out_a), "--save-cmaps"])
        secs_a = time.perf_counter() - t0
    finally:
        BatchedPredictor._run_batch = real_run_batch
        logging.getLogger().handlers.clear()
    launches = launch_counts()
    if rc != 0:
        raise AssertionError(f"run A exited {rc}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else float("nan"))
    gcn_batches = [b for b in batches if b[0] == "gcn_coords"]
    log(f"  run A (in process): {secs_a:.2f} s, "
        f"{n_queries / secs_a:.2f} queries/s end to end on {smi}")
    log(f"  run A profile: {json.dumps(profiling.report())}")
    log(f"  run A batches (net, bucket, batch, proteins): {batches}")
    log(f"  run A peak device memory: {peak:.2f} GiB on {smi}")

    # Run C: run A again under torch.profiler (CUDA activity only) for the
    # device's busy share of an end-to-end run; its wall time is not used.
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rc = cli.main(argv + ["-o", str(root / "run_c"), "--save-cmaps"])
            torch.cuda.synchronize()
    finally:
        logging.getLogger().handlers.clear()
    secs_c = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6
    if rc != 0:
        raise AssertionError(f"run C exited {rc}")
    log(f"  run C (run A under torch.profiler): {secs_c:.2f} s wall, "
        f"{busy:.3f} s of device time, busy share {busy / secs_c:.3f}, "
        f"idle share {1 - busy / secs_c:.3f} on {smi}")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "metagenomic_deepfri_tpu_torch.cli", *argv,
         "-o", str(out_b), "--skip-matrix"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=P7_RUN_B_TIMEOUT)
    secs_b = time.perf_counter() - t0
    (root / "run_b.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise AssertionError(f"run B exited {proc.returncode}")
    reruns = [ln for ln in proc.stdout.splitlines() if "Re-running" in ln]
    log(f"  run B (subprocess, --skip-matrix): {secs_b:.2f} s, "
        f"{n_queries / secs_b:.2f} queries/s end to end on {smi}; "
        f"{reruns[0].split(':: ')[-1] if reruns else 'no dense re-run'}")

    # Check 2: every hit aligned to its own source, no no-hit, none dropped.
    _, summary = read_tsv(out_a / "alignment_summary.tsv")
    rows = {r[0]: r for r in summary}
    wrong = [q for q, sid in hits.items()
             if rows.get(q, [None, None, None])[1:3] != ["True", sid]]
    aligned_no_hits = [q for q in no_hits if rows[q][1] != "False"]
    if wrong or aligned_no_hits or any(q in rows for q in dropped) or \
            len(rows) != len(hits) + len(no_hits):
        raise AssertionError(f"alignment summary: hits misaligned {wrong[:5]}"
                             f", no-hits aligned {aligned_no_hits[:5]}")
    log(f"  alignment summary: {len(hits)}/{len(hits)} hits on their source "
        f"structure, 0/{len(no_hits)} no-hits aligned")

    # Check 3: 3 B1 and 1 B2 launches per mode per GCN batch.
    expect_launches(launches, {
        "graphconv_aggregate": 3 * len(MODES) * len(gcn_batches),
        "contact_degrees": len(MODES) * len(gcn_batches),
        "contact_map": 0}, f"run A, {len(gcn_batches)} GCN batches")

    # Check 4: matrix rows against the ONNX graphs on the host.
    t0 = time.perf_counter()
    oracle = onnx_oracle(weights, out_a, list(hits)[:P7_ORACLE], no_hits[
        :P7_ORACLE])
    log(f"  prediction matrices vs ONNX on the host ({P7_ORACLE} hit + "
        f"{P7_ORACLE} no-hit queries, {len(MODES)} modes, "
        f"{time.perf_counter() - t0:.2f} s): max|Δ|={oracle:.3g} "
        f"(atol {P7_ORACLE_ATOL})")
    if not oracle <= P7_ORACLE_ATOL:
        raise AssertionError("prediction matrix differs from the ONNX graph")

    # Check 5: run B (top-k fetch, dense re-run of overflows) against run A.
    if (out_a / "alignment_summary.tsv").read_bytes() != \
            (out_b / "alignment_summary.tsv").read_bytes():
        raise AssertionError("run B's alignment summary differs from A's")
    same = (out_a / "results.tsv").read_bytes() == \
        (out_b / "results.tsv").read_bytes()
    stats = compare_runs(out_a, out_b, rerun_groups(out_a))
    log(f"  run B's results.tsv vs run A's: byte-identical {same}; "
        f"{json.dumps(stats)} (re-run blocks held to {P7_SCORE_ATOL:.4g})")
    # Checks 6 and 7.
    n_rows = check_results(out_a, len(MODES))
    log(f"  results.tsv: {n_rows} rows, every mode, all ≥ "
        f"{SCORE_THRESHOLD}, sorted; results_propagated.tsv "
        f"{len(read_tsv(out_a / 'results_propagated.tsv')[1])} rows")
    return launches


def main() -> int:
    # Phase 1: device.
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port's main path needs a GPU")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # Phase 2: build.
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    log_path = lib_path.with_suffix(".log")
    if log_path.is_file():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {line.strip()}")

    # Phase 3: kernels against their plain twins.
    log("phase 3: kernels vs plain twins")
    errors = phase_kernels(dev)

    # Phase 4: the slice at full width.
    items = synthetic.aligned_items(N_PROTEINS, seed=SEED)
    handles = {dt: make_handles(dt, dev) for dt in ("bfloat16", "float32")}
    engines = {dt: BatchedPredictor(h, device=dev, batch_cap=BATCH_CAP)
               for dt, h in handles.items()}
    n_batches = expected_batches(items)
    log(f"phase 4: {N_PROTEINS} proteins, {len(MODES)} modes, "
        f"{n_batches} batches per engine")

    reset_launch_counts()
    results = {dt: run_stream(eng, items) for dt, eng in engines.items()}
    launches = launch_counts()
    expect_launches(launches, {
        "contact_degrees": 2 * len(MODES) * n_batches,
        "graphconv_aggregate": 2 * 3 * len(MODES) * n_batches,
        "contact_map": 0}, "bf16 and f32 engines")
    for dt, (out, n, secs) in results.items():
        if n != N_PROTEINS:
            raise AssertionError(f"{dt}: processed {n} of {N_PROTEINS}")
        check_scores(out, items)
        log(f"  {dt}: first pass {secs:.2f} s (includes warm-up)")

    dense = BatchedPredictor(handles["float32"], device=dev,
                             batch_cap=BATCH_CAP, spmm="dense")
    reset_launch_counts()
    dense_out, _, _ = run_stream(dense, items)
    if any(launch_counts().values()):
        raise AssertionError("the dense plain route launched a kernel")
    f32_vs_dense = max_diff(results["float32"][0], dense_out)
    bf16_vs_f32 = max_diff(results["bfloat16"][0], results["float32"][0])
    log(f"  float32 fused vs dense plain route: max|Δ|={f32_vs_dense:.3g} "
        f"(atol {SLICE_ATOL})")
    log(f"  bfloat16 vs float32 fused: max|Δ|={bf16_vs_f32:.3g} "
        "(reported, not asserted)")
    if not f32_vs_dense <= SLICE_ATOL:
        raise AssertionError("float32 slice differs from the dense route")

    for dt, eng in engines.items():
        _, _, secs = run_stream(eng, items)
        log(f"  warm pass {dt}: {N_PROTEINS / secs:.2f} proteins/s "
            f"({secs:.3f} s, {len(MODES)} modes) on {smi}")
        shares = stage_shares(handles[dt]["bp"], items, dev)
        log(f"  stage shares {dt} (bucket 512, batch {TIMED_BATCH}, one "
            f"mode): {json.dumps(shares)}")

    times = kernel_times(dev)
    log(f"kernel times (B={TIMED_BATCH}, CUDA events, mean of 10) on {smi}:")
    for r in times:
        log(f"  {json.dumps(r)}")

    # Phase 5: the fine-tuning path (B3 builds each batch's adjacency).
    launches["contact_map"] = phase_finetune(dev, smi)
    cmap_times = contact_map_times(dev)
    log(f"contact_map times (CUDA events, mean of 10) on {smi}:")
    for r in cmap_times:
        log(f"  {json.dumps(r)}")

    with tempfile.TemporaryDirectory() as tmp:
        # Phase 6: the published model set, both networks, both GCN routes.
        weights = Path(tmp) / "weights"
        phase_models(dev, smi, items, weights)
        # Phase 7: predict-function end to end (B1/B2 in every GCN batch).
        for name, n in phase_predict(dev, smi, weights, Path(tmp),
                                     "cuda").items():
            launches[name] += n

    def headline(name):
        if name == "contact_map":  # the fine-tuning batch: B=8, bucket 512
            return next(r for r in cmap_times if r["B"] == FT_BATCH
                        and r["bucket"] == 512)
        return next(r for r in times if r["kernel"] == name
                    and r["bucket"] == 512 and r["dtype"] == "float32"
                    and r["D"] in (None, 1024))

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errors[name], "ms": headline(name)["ms"],
         "plain_ms": headline(name)["plain_ms"]}
        for name in ("graphconv_aggregate", "contact_degrees",
                     "contact_map")]}
    log(json.dumps(summary))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
