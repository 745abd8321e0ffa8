#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on NVIDIA GPUs, and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure exits non-zero:

1. Device: a CUDA device is required (no CPU fallback); prints its name,
   the device count and ``nvidia-smi``'s name and power limit.
2. Build: compiles ``metagenomic_deepfri_tpu_torch/csrc/*.cu`` with nvcc
   (``graphconv.cu``: B1, B2; ``contact.cu``: B3; ``esm_gemm.cu``: E1),
   prints ptxas's register and spill counts, and fails unless every
   instance of B1 and of E1 issues ``HGMMA`` (wgmma) in the SASS that
   ``cuobjdump`` shows.
3. Kernels against their plain PyTorch twins on the card, at B=4,
   L ∈ {130, 512} (sentinels and insertions) plus a near-threshold batch
   (pairs at 6 Å ± 1 ulp): degrees and contact maps exact, aggregation
   rtol 1e-5 / atol 1e-4 for D ∈ {37, 48, 200, 512, 1024} in float32 and
   bfloat16 compute (D = 37 takes 4-byte copies; D = 200 mixes features
   of magnitude 1e30, 1 and 1e-30), and float32 for D ∈ {48, 1024} with
   one finite feature past bfloat16's range (up to float32's largest) in
   each protein: finite, within the same tolerance.
4. The inference slice at full published width: three GCN modes (bp 3992,
   cc 320, mf 489 terms; LSTM-LM 512×2, embed 1024, GraphConv 512×3,
   FC 1024) with seeded random weights, 96 alignment-projected proteins of
   length 40–500, through ``BatchedPredictor(device="cuda",
   spmm="fused").predict_stream`` in bfloat16 and float32. Checks ids, finiteness, range, kernel launch
   counts, and the float32 scores against the dense plain route on the card
   (atol 1e-4). Times a warm pass (proteins/s), the forward's stage shares,
   and each kernel at the main path's shapes: CUDA-event time (launch
   included), device time from ``torch.profiler``, host time (their
   difference), the twin's time, the bound of the launch (bytes or
   operations, from the real lengths) and, for B1, ``torch.bmm`` on the
   dense adjacency (float32 with TF32 off, and bf16 operands).
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
   ``predict_stream`` on the fused route (``spmm="fused"``, B1/B2 launches
   counted) and on the
   dense route's shared-trunk step (atol 1e-4 between them), 64 sequences
   without a structure hit (length 40–1000) through ``predict_cnn`` (each
   row within 1e-5 of its unpadded single-protein run on the card). The
   same 96 proteins as
   dense contact maps (each one's adjacency from the card, as bool)
   through ``predict_gcn`` on the shared-trunk step and per mode, each
   within 1e-4 of ``predict_gcn_from_coords`` on that route, no kernel
   launched, and the uint8 bytes each batch sends to the card. Times a
   warm pass of each route (``predict_gcn`` too) and the CNN (passes
   taken in turns, median of 3).
7. ``predict-function`` end to end through the port's command line on
   phase 6's weights (bp, cc, mf): a directory of 384 CA-trace PDB files
   (length 40–500) as the structure database; 256 queries copied from
   distinct structures with about 5 % substitutions and one or two short
   indels, 128 random queries (length 40–1000), two selenoproteins and two
   of length 1200 (``--max-length 1000``); the built-in search, NW
   re-alignment, coordinates, projections, the GCN on the engine's default
   ``spmm="auto"`` route (3-mode shared-trunk steps), the CNN fallback, saved contact maps, matrices, ``results.tsv`` and GO
   propagation over a mini OBO. Run A is ``cli.main`` in this process (B1/B2
   launches counted); run B is ``python -m metagenomic_deepfri_tpu_torch.cli``
   in a subprocess with ``--skip-matrix`` (no matrix files, the same
   batches). Checks: both exit 0; every hit query aligned to its own
   structure and no random one, the filtered queries absent; 3 B1 and 1 B2
   launches per mode of each GCN batch that ``resolve_spmm`` sends to the
   fused kernels, none for a shared-trunk batch; 8 hit and 8 no-hit matrix rows within
   1e-4 of the ONNX graphs run on the host by the port's numpy executor
   (the GCN fed the saved aligned contact map); run B's ``results.tsv``
   byte-identical to run A's; rows for every mode, all ≥ 0.1, sorted; a
   larger
   ``results_propagated.tsv``. Prints both runs' wall time and
   queries/s (with run B's ``inference/gcn`` seconds), run A's stage
   profile, GCN batches and peak device memory,
   the device's busy share of run A repeated under ``torch.profiler``
   (run C), and the g++ version.
8. The resident annotation server (``serving.AnnotationServer(device=
   "cuda")``) on phase 6's weights and phase 7's structures, with run A's
   search settings and threads; its background warmup (one small batch of
   each route at bucket 512) is waited for and its launches checked, then
   it answers over its Unix socket from a thread: one cold request of 8
   proteins, 16 single-protein requests in sequence (idle), then 48
   requests of 1–32 proteins (seeded sizes) from 8 concurrent clients
   (load), drawn from phase 7's hit, no-hit and selenoprotein queries.
   Checks: each response covers its request's ids;
   hits aligned to their own structure, no random query aligned,
   selenoproteins skipped; scores ≥ 0.1 and sorted; every served protein's
   rows equal run A's ``results.tsv`` rows (scores within one unit of the
   4th decimal, a term within that of 0.1 on one side only); B1/B2
   launches as in phase 7 for every GCN batch the server ran. Prints
   the cold latency, idle and loaded p50/p90/p99, proteins/s under load,
   requests coalesced per pass, the engine's share of the passes' time,
   the device's busy share of two load-sized passes under
   ``torch.profiler``, and peak device memory. Then the ``serve`` verb in a
   fresh process: seconds until its socket accepts (once its warmup has
   ended), one cold single-protein request at once, 8 idle ones (cold and
   idle p50 ms, seconds to the cold answer);
   ``--parent DIR`` adds the same for the checkout at ``DIR`` (its kernels
   built first), in the order parent, this, this, parent, and in phase 7
   that checkout's run B before and after this one's.
9. The ``benchmark`` verb through ``cli.main`` at bucket 512 with
   ``--batches 2`` (its JSON line printed; the card named; 0 < MFU ≤ 1;
   its launches counted), ``bench_utils.run_gcn_benchmark(path="dense")``
   beside it (the dense-cmap API, no kernel launch), ``bench_utils``'
   multi-mode, roofline and CNN
   measurements at bucket 512, a short spmm matrix (buckets 128 and 512,
   2 forwards a pass) printed beside ``AUTO_SPMM_TABLE`` (a disagreement
   is logged, not fatal), one device-only pass under
   ``profiling.torch_trace`` whose Chrome trace must hold B1's kernel
   events, and ``nw_score_many_device(device="cuda")`` equal to the host
   NW on 200 seeded pairs.

10. Every visible card (one rank, or one engine replica, a card; on one
    card a world of 1, where the ring makes no exchange and every
    collective spans one rank; a device list beyond the cards raises):
    B1/B2/B3 on each card against their twins there; (a) a
    ``BatchedPredictor`` over all cards on phase 4's proteins and a
    bucket-512 catalogue of 256, every score within 1e-4 of the one-card
    engine's, on the fused route (mf) and under ``"auto"`` (bp/cc/mf,
    shared trunk), launches checked per batch and card, proteins/s on one
    card and on all; (b) phase 5's fine-tuning over one NCCL rank a card
    (model axis 2 on an even count), the checkpoint and losses normwise
    within 1e-4 of phase 5's, B3 once a step a rank, s/step; (c) the
    graph-sharded forward at L 4096 (2 proteins) against ``gcn_forward`` on
    the dense adjacency on one card (atol 1e-4), B2 once a forward a rank,
    ms a forward and peak memory a rank; (d) ``bench_utils.
    run_mesh_benchmark``'s rows (engine and ring at fixed work over 1, 2,
    4, … cards).
11. The trunks' projections, E1 (``ops/esm_gemm.py``): ``esm_gemm`` on
    ``qkv``, ``out``, ``fc1`` and ``fc2`` of ESM-2 650M (d 1280, FFN 5120)
    at M 33,280 (a batch's token slots) and 33,243 (a ragged edge), each
    with its bias and epilogue (GELU; the residual add), and on ``qkv``,
    ``o``, ``wi`` and ``wo`` of ProtT5-XL-UniRef50 (d 1024, inner 4096,
    d_ff 16,384) at M 33,024, none with a bias (``bias=None``; nothing
    after the product, the residual add, ReLU; K up to 16,384), and on
    ``qkv``, ``out``, ``fc1`` and ``fc2`` of ESM C 600M (d 1152, SwiGLU
    3,072: ``fc1`` computes 6,144 columns and writes ``silu(a) ⊙ b``,
    3,072) at M 33,280, none with a bias, against ``esm_gemm_ref``
    (relative to |x|·|W| + |b| (+ |residual|), for SwiGLU to
    |silu'(a)|·|b|·(|x|·|W_a|) + |silu(a)|·(|x|·|W_b|): each element within
    2⁻²¹ at ESM-2's shapes and 2⁻²⁰ at ProtT5's and ESM C's, and normwise
    within 2⁻²³) and float64 (each element at most twice the error of
    cuBLAS's ``torch.addmm`` or ``torch.mm`` in float32 with TF32 off on the
    same inputs, with the same epilogue, and normwise at most 1.5 times);
    at each shape a twin without its lo planes must fail both; x and W
    from 2⁻¹⁰³ to float32's largest against the identity, bit for bit.
    Times each shape at M 33,280 and 33,024 (TFLOP/s beside cuBLAS's).
    Then the mf GCN on each published trunk, ESM-2's, ProtT5's and ESM C's,
    through ``BatchedPredictor.predict_stream`` on 64 proteins of bucket
    512 (one batch), the launch count zeroed just before each: 4 E1
    launches a layer and a batch (132, 96 and 144), ``split`` 1 on every
    ``model/esm/gemm``, ``model/t5/gemm`` or ``model/esmc/gemm`` span, and
    one E2 launch a layer and a batch (33, 24 and 36), ``split`` 1 on every
    ``model/esm/sdpa``, ``model/t5/sdpa`` or ``model/esmc/sdpa`` span;
    scores finite and in [0, 1].
12. The trunks' attention, E2 (``ops/attention.py``): ``attention`` at
    each bucket's main-path shape of ESM-2 650M (20 heads of 64, no bias)
    and ProtT5-XL-UniRef50 (32 heads of 128, T5's bias from its tables),
    256, 128, 64 and 32 rows at buckets 128-1024 (the traffic's lognormal
    lengths in the bucket, an empty row), q, k and v views of one
    projection output: normwise over the valid rows, against float64 at
    most 1.5 times the error of PyTorch's float32 attention (TF32 off) on
    the same inputs, and within 2⁻²⁰ of its twin (times the logits' scale);
    a twin with every operand cut to its hi and mid planes must fail both;
    then logits to ~±90, and rows of 1 and 2 valid tokens. Times E2, its twin and PyTorch's float32
    attention at bucket 1024 (``library_ms``: the port calls it nowhere).

Last, the kernel summary (launches on the main path, phases 4–11, every
rank's included; max |Δ|, ms, plain, device, bound and library ms; E1 at
ESM-2's fc1, at ProtT5's wo and at ESM C's gated fc1; E2 at each trunk's bucket 1024, its max
the normwise distance to its twin), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --multi-only`` runs phases 1, 2 and 10 only, with
phase 10's references (phase 5's one-card fine-tuning, phase 6's model set
without its ONNX round trip): the call on several cards.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

try:
    from metagenomic_deepfri_tpu_torch import (bench_utils, parity,
                                               profiling, synthetic, training)
    from metagenomic_deepfri_tpu_torch.batching.buckets import (
        assign_bucket, bucket_plan, esm_batch_size, gcn_batch_size)
    from metagenomic_deepfri_tpu_torch.batching.engine import (
        BatchedPredictor, ModelHandle, _pad_batch, _pad_batch_coords)
    from metagenomic_deepfri_tpu_torch.batching.spmm_table import \
        resolve_spmm
    from metagenomic_deepfri_tpu_torch.models import (deepfri, esm2, esmc,
                                                      prott5)
    from metagenomic_deepfri_tpu_torch.models.convert import (
        gcn_params_from_numpy, gcn_params_to_numpy)
    from metagenomic_deepfri_tpu_torch.models.lstm import lstm_stack_forward
    from metagenomic_deepfri_tpu_torch.models import registry
    from metagenomic_deepfri_tpu_torch.models.registry import \
        load_model_handle
    from metagenomic_deepfri_tpu_torch.ops import _build
    from metagenomic_deepfri_tpu_torch.ops import attention as at
    from metagenomic_deepfri_tpu_torch.ops import contact
    from metagenomic_deepfri_tpu_torch.ops import esm_gemm as eg
    from metagenomic_deepfri_tpu_torch.ops import graphconv as gc
    from metagenomic_deepfri_tpu_torch.ops.cmap_align import \
        aligned_contacts_from_coords
    from metagenomic_deepfri_tpu_torch.ops.one_hot import tokens2onehot
    from metagenomic_deepfri_tpu_torch.parallel import launch, train
    from metagenomic_deepfri_tpu_torch.precision import (
        highest_f32_precision, use_highest_f32_precision)
except ModuleNotFoundError as err:
    raise SystemExit("chip_smoke.py runs from the root of a checkout of the "
                     f"repo: {err}") from None


REPO = Path(__file__).resolve().parent
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
# Terms whose median score sits on the threshold, in a head wider than
# 2 * P6_NEAR_TERMS (bp); an eighth of the head otherwise.
P6_NEAR_TERMS = 512
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
# Phase 8: the resident server on phase 6's weights and phase 7's inputs.
P8_COLD = 8
P8_IDLE = 16
P8_LOAD_REQUESTS = 48
P8_LOAD_CLIENTS = 8
P8_LOAD_SIZES = (1, 32)
P8_FRESH_IDLE = 8
P8_FRESH_TIMEOUT = 300
# Phase 9: the benchmark verb and bench_utils.
P9_BUCKET = 512
P9_BATCHES = 2
P9_DENSE_BATCHES = 1
P9_MATRIX_BUCKETS = (128, 512)
# Phase 10: several cards (one rank, or one engine replica, a card).
P10_CATALOGUE = 256
P10_CATALOGUE_LENGTHS = (205, 307)   # the bucket-512 range of bench_utils
P10_ROUNDS = 3
P10_L = 4096
P10_LENGTHS = (P10_L, P10_L - 301)
P10_REPS = 3
# Phase 11: ESM-2 650M's projections, (K, N, epilogue) of qkv, out, fc1, fc2,
# each with its bias.
ESM_PROJECTIONS = {"qkv": (1280, 3840, "bias"),
                   "out": (1280, 1280, "residual"),
                   "fc1": (1280, 5120, "gelu"),
                   "fc2": (5120, 1280, "residual")}
# A batch's token slots (256 rows of 130 at bucket 128), and a ragged edge.
ESM_ROWS = (33280, 33280 - 37)
# ProtT5-XL-UniRef50's projections, (K, N, epilogue) of qkv, o, wi, wo, none
# with a bias; a batch's token slots (256 rows of 129 at bucket 128).
T5_PROJECTIONS = {"qkv": (1024, 12288, "bias"),
                  "o": (4096, 1024, "residual"),
                  "wi": (1024, 16384, "relu"),
                  "wo": (16384, 1024, "residual")}
T5_ROWS = (33024,)
# ESM C 600M's projections, (K, N, epilogue) of qkv, out, fc1 (N the 2F
# columns the product computes; SwiGLU writes F) and fc2, none with a
# bias; a batch's token slots (256 rows of 130 at bucket 128).
ESMC_PROJECTIONS = {"qkv": (1152, 3456, "bias"),
                    "out": (1152, 1152, "residual"),
                    "fc1": (1152, 6144, "swiglu"),
                    "fc2": (3072, 1152, "residual")}
ESMC_ROWS = (33280,)
# E1 against its twin, relative to |x|·|W| + |b| (+ |residual|): both round
# in float32. Each element: within 2^-21 at ESM-2's shapes (a dropped lo
# plane reads 1.6e-6 to 3.5e-6), 2^-20 at ProtT5's (the twin's float32 sums
# run to K 16,384, where a dropped lo plane reads ~1e-6 and no elementwise
# bound tells the two apart), 2^-20 at ESM C's (the gated fc1's silu and
# product round once more). Normwise (the difference's RMS over the
# scale's): within 2^-23 at every shape, where a twin without its lo planes
# reads 2e-7 (K 16,384) to 8e-7 (K 1,024) on the CPU; phase 11 checks on
# the card that such a twin exceeds it at each shape. Against float64,
# normwise: at most 1.5 times cuBLAS float32's error.
ESM_TWIN_RTOL = 2.0 ** -21
T5_TWIN_RTOL = 2.0 ** -20
ESMC_TWIN_RTOL = 2.0 ** -20
GEMM_TWIN_RMS = 2.0 ** -23
GEMM_LIB_RATIO = 1.5
# The main-path batch of each trunk: one batch at bucket 512
# (esm_batch_size(512) rows).
ESM_PROTEINS = 64
ESM_LENGTHS = (257, 512)
# E2's shapes: each trunk's heads, head dim, tokens beyond the residues and
# whether it has a position bias, at each bucket's main-path rows
# (esm_batch_size: 256, 128, 64, 32).
ATTN_TRUNKS = {"esm2": (20, 64, 2, False), "prott5": (32, 128, 1, True)}
ATTN_BUCKETS = (128, 256, 512, 1024)
# E2 against float64, normwise: at most 1.5 times the error of PyTorch's
# float32 attention (TF32 off) on the same inputs; against its twin (the
# same float32 attention, unsplit, in PyTorch's order) within 2^-20 times
# the logits' scale (float32's rounding of logits of order L moves both by
# L times as much: at L 25 on an H100 the twin is 1.3e-6 from float64,
# E2 4.7e-7),
# where operands cut to their hi and mid planes read 3e-5 at L 1 and 4.7e-5
# at L 25.
ATTN_LIB_RATIO = 1.5
ATTN_TWIN_RMS = 2.0 ** -20
# Config overrides (empty: the published width) of phase 5's and phase 10's
# GCNs, for rehearsals on the CPU.
FT_GCN = {}
P10_GCN = {}
SOURCES = {
    "graphconv_aggregate": "metagenomic_deepfri_tpu_torch/csrc/graphconv.cu",
    "contact_degrees": "metagenomic_deepfri_tpu_torch/csrc/graphconv.cu",
    "contact_map": "metagenomic_deepfri_tpu_torch/csrc/contact.cu",
    "esm_gemm": "metagenomic_deepfri_tpu_torch/csrc/esm_gemm.cu",
    "attention": "metagenomic_deepfri_tpu_torch/csrc/attention.cu",
}
REPLACES = {
    "contact_degrees": "metagenomic_deepfri_tpu/ops/graphconv_pallas.py:190",
    "graphconv_aggregate":
        "metagenomic_deepfri_tpu/ops/graphconv_pallas.py:275",
    "contact_map": "metagenomic_deepfri_tpu/ops/contact.py:193",
    "esm_gemm": None,  # the port's own: the JAX package has no ESM-2,
    # ProtT5 or ESM C
    "attention": None,  # the port's own: the JAX package has no trunk
}
SYMBOLS = {
    "contact_degrees": "contact_degrees_kernel",
    "graphconv_aggregate": "graphconv_aggregate_kernel",
    "contact_map": "contact_map_kernel",
    "esm_gemm": "esm_gemm_kernel",
    "attention": "attention_kernel",
}
# A kernel's bound is the larger of its bytes (each input read once, each
# output written once) over HBM3's rate and its operations over the peak of
# their type: one H100 SXM, NVIDIA's data sheet, dense.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
PAIR_OPS = 9  # one pair's distance test: 3 sub, 3 mul, 2 add, 1 compare


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0, this process's and the sums
    over the ranks that ``launch.run_ranks`` started."""
    gc.reset_launch_counts()
    contact.contact_map_fused.launches = 0
    launch.reset_rank_launch_counts()


def launch_counts() -> dict:
    """Launches since the last reset: this process's plus its ranks'."""
    ranks = launch.rank_launch_counts()
    return {"graphconv_aggregate": gc.graphconv_aggregate.launches
            + ranks["graphconv_aggregate"],
            "contact_degrees": gc.contact_degrees.launches
            + ranks["contact_degrees"],
            "contact_map": contact.contact_map_fused.launches
            + ranks["contact_map"]}


@contextlib.contextmanager
def watching_warmups():
    """Inside the block, a record of every ``BatchedPredictor.warmup``
    call: its engine, its future (None where it started none) and the host
    clock at its start and at its end."""
    rec = []
    real_warmup = BatchedPredictor.warmup

    def warmup(self, *args, **kwargs):
        entry = {"engine": self, "start": time.perf_counter(), "done": None}
        entry["future"] = future = real_warmup(self, *args, **kwargs)
        future.add_done_callback(
            lambda _: entry.__setitem__("done", time.perf_counter()))
        rec.append(entry)
        return future

    BatchedPredictor.warmup = warmup
    try:
        yield rec
    finally:
        BatchedPredictor.warmup = real_warmup


def warmup_report(entry: dict) -> dict:
    """One watched warmup: its shapes run and skipped (left to real
    dispatch), its seconds (on its thread) and host clock from the call to
    the end, and the B1/B2 launches its shapes make."""
    result = entry["future"].result()
    deadline = time.monotonic() + 10  # callbacks run after the waiters
    while entry["done"] is None and time.monotonic() < deadline:
        time.sleep(0.01)
    engine = entry["engine"]
    return {"shapes": result["shapes"], "skipped": result["skipped"],
            "seconds": result["seconds"],
            "call_to_end_s": entry["done"] - entry["start"],
            "launches": gcn_launches(sum(
                fused_modes(engine, bucket, list(engine.gcn_models))
                for net, bucket, _ in result["shapes"]
                if net == "gcn_coords"))}


def no_launches() -> dict:
    return gcn_launches(0)


def plus(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


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


def mixed_magnitudes(xs: torch.Tensor) -> torch.Tensor:
    """Features scaled by 1e30 (one sign a column, so sums do not cancel),
    1e-30 and 1 in turn along the last axis: every exponent band of the
    three-plane split."""
    out = xs.clone()
    big = out[..., 0::3]
    out[..., 0::3] = big.abs() * 1e30 * torch.where(
        torch.arange(big.shape[-1]) % 2 == 0, 1.0, -1.0)
    out[..., 1::3] *= 1e-30
    return out


def check_hgmma(lib_path: Path) -> None:
    """Phase 2: every instance of B1 and of E1 must issue HGMMA (wgmma) in
    SASS."""
    sass = _build.kernel_sass(lib_path)
    for kernel in ("graphconv_aggregate", "esm_gemm"):
        symbol = SYMBOLS[kernel]
        found = [code for name, code in sass.items() if symbol in name]
        with_hgmma = sum("HGMMA" in code for code in found)
        log(f"  SASS: {with_hgmma} of {len(found)} {symbol} instances issue "
            "HGMMA")
        if not found or with_hgmma != len(found):
            raise AssertionError(f"{symbol} does not use the tensor cores "
                                 "(no HGMMA in its SASS)")


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
        for D in (37, 48, 200, 512, 1024):
            xs = torch.randn((coords.shape[0], coords.shape[1], D),
                             generator=g)
            if D == 200:
                xs = mixed_magnitudes(xs)
            xs = xs.to(dev)
            for cdt in ("float32", "bfloat16"):
                out = gc.graphconv_aggregate(coords, ins, lengths, xs,
                                             compute_dtype=cdt)
                ref = gc.graphconv_aggregate_ref(coords, ins, lengths, xs,
                                                 compute_dtype=cdt)
                torch.cuda.synchronize()
                d = (out - ref).abs().max().item()
                if D == 200:  # values up to ~1e31: report the share of
                    # the tolerance used, max |Δ| / (atol + rtol·|ref|)
                    used = ((out - ref).abs() / (AGG_TOL["atol"] + AGG_TOL[
                        "rtol"] * ref.abs())).max().item()
                    log(f"  graphconv_aggregate {name} D={D} {cdt} (features "
                        f"1e30/1/1e-30): tolerance used {used:.3g}")
                else:
                    err["graphconv_aggregate"] = max(
                        err["graphconv_aggregate"], d)
                    log(f"  graphconv_aggregate {name} D={D} {cdt}: "
                        f"max|Δ|={d:.3g}")
                torch.testing.assert_close(out, ref, **AGG_TOL)
        for D in (48, 1024):  # one finite value past bf16's range a protein
            xs = torch.from_numpy(synthetic.with_float32_extremes(
                torch.randn((coords.shape[0], coords.shape[1], D),
                            generator=g).numpy(),
                lengths.cpu().numpy())).to(dev)
            out = gc.graphconv_aggregate(coords, ins, lengths, xs)
            ref = gc.graphconv_aggregate_ref(coords, ins, lengths, xs)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(out).all())
                    and bool(torch.isfinite(ref).all())):
                raise AssertionError(f"graphconv_aggregate {name} D={D}: "
                                     "non-finite sums of finite features")
            used = ((out - ref).abs() / (AGG_TOL["atol"] + AGG_TOL[
                "rtol"] * ref.abs())).max().item()
            log(f"  graphconv_aggregate {name} D={D} float32 (one feature "
                f"past bf16's range a protein, |ref| up to "
                f"{ref.abs().max().item():.5g}): tolerance used {used:.3g}")
            torch.testing.assert_close(out, ref, **AGG_TOL)
    return err


def gemm_sets():
    """Phase 11's shapes: (trunk, projections, rows, with a bias, the
    elementwise tolerance to the twin) of ESM-2, ProtT5 and ESM C."""
    return (("esm2", ESM_PROJECTIONS, ESM_ROWS, True, ESM_TWIN_RTOL),
            ("prott5", T5_PROJECTIONS, T5_ROWS, False, T5_TWIN_RTOL),
            ("esmc", ESMC_PROJECTIONS, ESMC_ROWS, False, ESMC_TWIN_RTOL))


def gemm_operands(shape, M: int, bias: bool, dev):
    """x, W, b (None without a bias), the epilogue and its residual (or
    None) of one projection ``(K, N, epilogue)`` at M rows: x normal, W
    Glorot-uniform, b uniform in (-0.1, 0.1)."""
    K, N, epilogue = shape
    gen = torch.Generator(device=dev).manual_seed(SEED + K + N + M)

    def uniform(*shape, scale):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * scale

    x = torch.randn(M, K, generator=gen, device=dev)
    w = uniform(K, N, scale=(6.0 / (K + N)) ** 0.5)
    b = uniform(N, scale=0.1) if bias else None
    res = (torch.randn(M, N, generator=gen, device=dev)
           if epilogue == "residual" else None)
    return x, w, b, epilogue, res


def esm_epilogue(y, epilogue: str, residual):
    """The trunks' epilogue after the product and its bias, as PyTorch
    computes it."""
    if epilogue == "gelu":
        return torch.nn.functional.gelu(y)
    if epilogue == "relu":
        return torch.relu(y)
    if epilogue == "swiglu":
        a, b = y.chunk(2, dim=-1)
        return torch.nn.functional.silu(a) * b
    return y if residual is None else residual + y


def swiglu_scale(y, scale):
    """SwiGLU of the float64 product's halves ``[a | b]``, and its
    condition scale |silu'(a)|·|b|·s_a + |silu(a)|·s_b, where s = |x|·|W|
    is the product's."""
    a, b = y.chunk(2, dim=-1)
    sa, sb = scale.chunk(2, dim=-1)
    sig = torch.sigmoid(a)
    silu = a * sig
    slope = (sig * (1 + a * (1 - sig))).abs_()
    return silu * b, slope * b.abs() * sa + silu.abs() * sb


def library_gemm(x, w, b, epilogue: str, residual):
    """The trunks' path before E1: cuBLAS in float32 (TF32 off),
    ``torch.addmm`` (``torch.mm`` without a bias), then the epilogue."""
    y = torch.mm(x, w) if b is None else torch.addmm(b, x, w)
    return esm_epilogue(y, epilogue, residual)


def without_lo(x, planes):
    """x and W's planes with their lo planes dropped: what the twin reads
    for a kernel that lost them."""
    hi, mid, _ = eg._split_bf16x3(x)
    cut = planes.clone()
    cut[2].zero_()
    return hi.float() + mid.float(), cut


def esm_gemm_checks(dev) -> float:
    """Phase 11's accuracy checks (see the module's docstring); returns E1's
    max |Δ| to its twin."""
    worst = 0.0
    with highest_f32_precision():
        for trunk, table, rows, bias, rtol in gemm_sets():
            for proj, shape in table.items():
                for M in rows:
                    worst = max(worst, gemm_check(trunk, proj, shape, M, bias,
                                                  rtol, dev))
        rng = np.random.default_rng(SEED)
        K, other = 256, 300
        v = (rng.choice([-1.0, 1.0], (other, K))
             * 10.0 ** rng.uniform(-30, 30, (other, K))).astype(np.float32)
        f32_max = float(np.finfo(np.float32).max)
        v[0, :8] = (f32_max, -f32_max, 3.3962e38, -3.4e38, 2.0 ** -103,
                    -(2.0 ** -103), 0.0, -0.0)
        v = torch.from_numpy(v).to(dev)
        eye = torch.eye(K, device=dev)
        as_x = eg.esm_gemm(v, eye, torch.zeros(K, device=dev))
        as_w = eg.esm_gemm(eye, v.t().contiguous(),
                           torch.zeros(other, device=dev))
        if not (torch.equal(as_x, v) and torch.equal(as_w, v.t())):
            raise AssertionError("esm_gemm: the planes lose bits between "
                                 "2**-103 and float32's largest value")
        log("  esm_gemm x and W at float32's extremes against the identity: "
            "bit for bit")
    torch.cuda.empty_cache()
    return worst


def gemm_check(trunk: str, proj: str, shape, M: int, bias: bool,
               rtol: float, dev) -> float:
    """One projection of phase 11: E1 against its twin and float64, and a
    twin without its lo planes against the same bounds; returns E1's max
    |Δ| to its twin."""
    x, w, b, epi, res = gemm_operands(shape, M, bias, dev)
    got = eg.esm_gemm(x, w, b, epi, res)
    planes = eg.weight_planes(w)
    twin = eg.esm_gemm_ref(x, planes, b, epi, res)
    cut = eg.esm_gemm_ref(*without_lo(x, planes), b, epi, res)
    x64, w64 = x.double(), w.double()
    want = x64 @ w64
    scale = x64.abs() @ w64.abs()
    del x64, w64
    if b is not None:
        want += b.double()
        scale += b.double().abs()
    if epi == "swiglu":
        want, scale = swiglu_scale(want, scale)
    else:
        want = esm_epilogue(want, epi, None if res is None else res.double())
    if res is not None:
        scale += res.double().abs()
    scale_norm = scale.norm()

    def rel(a, r) -> list:
        """Max and normwise |a − r| over the scale."""
        d = (a.double() - r).abs_()
        return [float((d / scale).max()), float(d.norm() / scale_norm)]

    err = {"split": rel(got, want),
           "twin": rel(twin, want),
           "cublas": rel(library_gemm(x, w, b, epi, res), want),
           "to_twin": rel(got, twin.double()),
           "cut_to_twin": rel(cut, twin.double()),
           "cut": rel(cut, want)}
    worst = float((got - twin).abs().max())
    log(f"  esm_gemm {trunk} {proj} M={M} ({epi} epilogue, "
        f"{'a' if bias else 'no'} bias): relative error [max, normwise] "
        f"{json.dumps(err)}")
    name = f"esm_gemm {trunk} {proj} M={M}"
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: not finite")
    if not err["split"][0] <= 2 * err["cublas"][0]:
        raise AssertionError(f"{name}: over twice cuBLAS float32's error")
    if not err["split"][1] <= GEMM_LIB_RATIO * err["cublas"][1]:
        raise AssertionError(f"{name}: normwise over {GEMM_LIB_RATIO} times "
                             "cuBLAS float32's error")
    if not (err["to_twin"][0] <= rtol and err["to_twin"][1] <= GEMM_TWIN_RMS):
        raise AssertionError(f"{name}: differs from its twin")
    if not (err["cut_to_twin"][1] > GEMM_TWIN_RMS
            and err["cut"][0] > 2 * err["cublas"][0]):
        raise AssertionError(f"{name}: the bounds would pass a kernel that "
                             "dropped its lo planes")
    del want, scale, got, twin, cut
    torch.cuda.empty_cache()
    return worst


def esm_gemm_times(dev) -> list:
    """E1 and its twin on each projection of both trunks at their first
    row count, with the launch's bound (the float32 work, 2·M·K·N, at the
    tensor cores' bf16 rate, or its bytes at HBM3's, the larger) and the
    trunks' former yardstick, :func:`library_gemm`."""
    rows = []
    with highest_f32_precision():
        for trunk, table, counts, bias, _ in gemm_sets():
            M = counts[0]
            for proj, shape in table.items():
                K, N, _ = shape
                x, w, b, epi, res = gemm_operands(shape, M, bias, dev)
                planes = eg.weight_planes(w)
                flops = 2 * M * K * N
                out = N // 2 if epi == "swiglu" else N
                nbytes = (4 * M * K + 6 * K * N + (4 * N if bias else 0)
                          + 4 * M * out * (1 if res is None else 2))
                t_ops = flops / BF16_TENSOR_FLOP_PER_S
                t_bytes = nbytes / HBM_BYTES_PER_S
                row = timed_row(
                    "esm_gemm", lambda: eg.esm_gemm(x, w, b, epi, res),
                    lambda: eg.esm_gemm_ref(x, planes, b, epi, res),
                    (max(t_ops, t_bytes) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations"),
                    trunk=trunk, proj=proj, M=M, K=K, N=N,
                    library_ms=cuda_ms(
                        lambda: library_gemm(x, w, b, epi, res)))
                row["tflop_s"] = flops / row["ms"] / 1e9
                row["library_tflop_s"] = flops / row["library_ms"] / 1e9
                rows.append(row)
                del x, w, b, res, planes
                torch.cuda.empty_cache()
    return rows


def trunk_main_path(dev, smi, cfg, span: str) -> tuple:
    """Phase 11's main-path run of one trunk (see the module's docstring);
    returns E1's and E2's launches."""
    trunk = deepfri.trunk_of(cfg)
    name = type(trunk).__name__
    params = deepfri.init_gcn(cfg, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    engine = BatchedPredictor({"mf": ModelHandle("gcn", "mf", cfg, params)},
                              device=dev)
    items = synthetic.aligned_items(ESM_PROTEINS, seed=SEED + 11,
                                    min_len=ESM_LENGTHS[0],
                                    max_len=ESM_LENGTHS[1])
    per_bucket = {}
    for _, seq, _, _ in items:
        b = assign_bucket(len(seq))
        per_bucket[b] = per_bucket.get(b, 0) + 1
    n_batches = sum(-(-n // esm_batch_size(b)) for b, n in per_bucket.items())
    eg.esm_gemm.launches = at.attention.launches = 0
    sdpa_span = span.replace("/gemm", "/sdpa")
    profiling.reset()
    profiling.set_recording(True)
    try:
        out, n, secs = run_stream(engine, items, modes=["mf"])
        got = profiling.spans()
    finally:
        profiling.set_recording(None)
        profiling.reset()
    gemm = [s for s in got if s.name == span]
    sdpa = [s for s in got if s.name == sdpa_span]
    lm = [s for s in got if s.name == "model/lm"]
    launches = eg.esm_gemm.launches
    want = 4 * trunk.layers * n_batches
    split = sum(s.counts["split"] for s in gemm)
    log(f"  {name} mf GCN: {n} proteins in {n_batches} batch(es) of "
        f"{sorted(per_bucket)} in {secs:.2f} s (first pass) on {smi}; "
        f"esm_gemm launches {launches}, {span} spans {len(gemm)} "
        f"with split 1 on {split}; expected {want} of each")
    attn = at.attention.launches
    attn_want = trunk.layers * n_batches
    attn_split = sum(s.counts["split"] for s in sdpa)
    pairs = sum(s.counts["pairs"] for s in sdpa)
    real = trunk.layers * sum(s.counts["attn_pairs"] for s in lm)
    log(f"  {name}: attention launches {attn}, {sdpa_span} spans "
        f"{len(sdpa)} with split 1 on {attn_split}; expected {attn_want} of "
        f"each; query-key pairs computed {pairs}, real {real}")
    if n != ESM_PROTEINS:
        raise AssertionError(f"{name}: processed {n} of {ESM_PROTEINS}")
    check_scores(out, items, modes=["mf"])
    if not launches == len(gemm) == split == want:
        raise AssertionError(f"{name}: the projections did not all take E1")
    if not attn == len(sdpa) == attn_split == attn_want:
        raise AssertionError(f"{name}: the attention did not all take E2")
    del engine, params
    torch.cuda.empty_cache()
    return launches, attn


def phase_esm(dev, smi):
    """Phase 11: returns E1's max |Δ| to its twin, its timed rows, and its
    and E2's launches on the main path."""
    log("phase 11: the trunks' projections (esm_gemm) at the published "
        "widths: ESM-2 650M's, ProtT5-XL-UniRef50's and ESM C 600M's")
    worst = esm_gemm_checks(dev)
    rows = esm_gemm_times(dev)
    log(f"esm_gemm times (CUDA events, mean of 10) on {smi}:")
    for r in rows:
        log(f"  {json.dumps(r)}")
    counts = [trunk_main_path(dev, smi, cfg, span) for cfg, span in (
        (deepfri.ESMGCNConfig(n_labels=MODES["mf"], esm=esm2.ESM2Config()),
         "model/esm/gemm"),
        (deepfri.ProtT5GCNConfig(n_labels=MODES["mf"],
                                 t5=prott5.ProtT5Config()),
         "model/t5/gemm"),
        (deepfri.ESMCGCNConfig(n_labels=MODES["mf"], esmc=esmc.ESMCConfig()),
         "model/esmc/gemm"))]
    return worst, rows, sum(c[0] for c in counts), sum(c[1] for c in counts)


def attention_case(trunk: str, bucket: int, dev, seed: int = SEED,
                   logit_scale: float = 1.0, valid=None):
    """E2's inputs at a trunk's main-path shape: q, k and v views of one
    (B, T, 3, H, D) projection output (q scaled so that logits are of
    order ``logit_scale``), each row's valid count (the traffic's lognormal
    lengths within the bucket and one empty row, or ``valid``), T5's bias
    tables or None, and the attention mask PyTorch's call took before E2
    (16-aligned rows; for ProtT5 the (B, H, T, T) bias joined with it)."""
    H, D, extra, biased = ATTN_TRUNKS[trunk]
    B, T = esm_batch_size(bucket), bucket + extra
    gen = torch.Generator(device=dev).manual_seed(seed + bucket)
    fused = torch.randn(B, T, 3, H, D, generator=gen, device=dev)
    fused[:, :, 0] *= logit_scale * D ** -0.5
    q, k, v = fused.permute(2, 0, 3, 1, 4)
    if valid is None:
        rng = np.random.default_rng(seed + bucket)
        n = np.clip(np.exp(rng.normal(np.log(270), 0.55, 40 * B)), 40, 1000)
        n = n[(n > bucket // 2) & (n <= bucket)].astype(int)[:B - 1]
        valid = (n + extra).tolist() + [extra] * (B - len(n))
    valid = torch.tensor(valid, device=dev, dtype=torch.int32)
    keys = torch.arange(T, device=dev)[None, :] < valid[:, None]
    bias = None
    width = -(-T // 16) * 16
    if biased:
        rel = torch.randn(prott5.ProtT5Config().buckets, H, generator=gen,
                          device=dev) * 0.5
        bias = (rel, prott5.distance_buckets(prott5.ProtT5Config(), T, dev))
        mask = torch.empty(B, H, T, width, device=dev)[..., :T]
        torch.add(at._bias_of(bias, T, torch.float32)[None],
                  torch.zeros(B, 1, 1, T, device=dev).masked_fill(
                      ~keys[:, None, None, :], float("-inf")), out=mask)
    else:
        mask = torch.zeros(B, 1, 1, width, device=dev)[..., :T].masked_fill(
            ~keys[:, None, None, :], float("-inf"))
    return q, k, v, valid, bias, mask


def library_attention(q, k, v, mask):
    """The trunks' attention before E2: PyTorch's fused call in float32
    with the additive mask, (B, T, H·D) (timed and held beside E2 here;
    the port calls it nowhere)."""
    B, H, T, D = q.shape
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v.contiguous(), attn_mask=mask, scale=1.0).transpose(
            1, 2).reshape(B, T, H * D)


def attention_without_lo(q, k, v, valid, bias):
    """The attention with every operand cut to its hi and mid planes (q, k,
    v and the softmax weights), in float64: what a kernel that dropped its
    lo planes would compute at best."""
    def cut(t):
        hi, mid, _ = gc._split_bf16x3(t.float())
        return hi.double() + mid.double()

    B, H, T, D = q.shape
    s = cut(q) @ cut(k).transpose(-1, -2)
    if bias is not None:
        s = s + at._bias_of(bias, T, torch.float64)
    keys = torch.arange(T, device=q.device)[None, :] < valid[:, None]
    s = s.masked_fill(~keys[:, None, None, :], float("-inf"))
    p = cut(torch.softmax(s, -1))
    return (p @ cut(v)).transpose(1, 2).reshape(B, T, H * D)


def attention_check(trunk: str, bucket: int, dev, **case) -> dict:
    """E2 at one shape against float64, its twin and PyTorch's float32
    attention, and the cut twin against the same bounds (see the module's
    docstring); the normwise errors over the valid rows."""
    q, k, v, valid, bias, mask = attention_case(trunk, bucket, dev, **case)
    T = q.shape[2]
    twin_rms = ATTN_TWIN_RMS * max(1.0, case.get("logit_scale", 1.0))
    launches = at.attention.launches
    got = at.attention(q, k, v, valid, bias)
    torch.cuda.synchronize()
    if at.attention.launches != launches + 1:
        raise AssertionError("attention: not one launch")
    rows = torch.arange(T, device=dev)[None, :] < valid[:, None]
    want = at.attention_ref(q.double(), k.double(), v.double(), valid,
                            bias)[rows]
    twin = at.attention_ref(q, k, v, valid, bias)[rows].double()
    lib = library_attention(q, k, v, mask)[rows].double()
    cut = attention_without_lo(q, k, v, valid, bias)[rows]
    norm = want.norm()
    err = {"e2": float((got[rows].double() - want).norm() / norm),
           "library": float((lib - want).norm() / norm),
           "twin": float((twin - want).norm() / norm),
           "cut": float((cut - want).norm() / norm),
           "e2_to_twin": float((got[rows].double() - twin).norm()
                               / twin.norm()),
           "cut_to_twin": float((cut - twin).norm() / twin.norm())}
    name = f"attention {trunk} bucket {bucket} {case or ''}".strip()
    log(f"  {name} (B {q.shape[0]}, H {q.shape[1]}, T {T}, D {q.shape[3]}): "
        f"normwise error {json.dumps(err)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: not finite")
    if not err["e2"] <= ATTN_LIB_RATIO * err["library"]:
        raise AssertionError(f"{name}: over 1.5 times PyTorch's float32 "
                             "attention's error")
    if not err["e2_to_twin"] <= twin_rms:
        raise AssertionError(f"{name}: differs from its twin")
    if not (err["cut"] > ATTN_LIB_RATIO * err["library"]
            and err["cut_to_twin"] > twin_rms):
        raise AssertionError(f"{name}: the bounds would pass a kernel that "
                             "dropped its lo planes")
    del want, twin, lib, cut, got
    torch.cuda.empty_cache()
    return err


def attention_checks(dev) -> float:
    """Phase 12's accuracy checks; returns E2's widest normwise distance
    to its twin."""
    worst = 0.0
    with highest_f32_precision():
        for trunk in ATTN_TRUNKS:
            for bucket in ATTN_BUCKETS:
                worst = max(worst, attention_check(trunk, bucket, dev)[
                    "e2_to_twin"])
            H, D, extra, _ = ATTN_TRUNKS[trunk]
            # Logits near float32's exp range (|s| to ~90); rows of 1 and 2
            # valid tokens and a full one, T not a multiple of the tile.
            worst = max(worst, attention_check(
                trunk, 128, dev, logit_scale=25.0)["e2_to_twin"])
            B = esm_batch_size(128)
            worst = max(worst, attention_check(
                trunk, 128, dev, seed=SEED + 1,
                valid=[1, 2, 128 + extra] + [65] * (B - 3))["e2_to_twin"])
    return worst


def attention_times(dev) -> list:
    """E2, its twin and PyTorch's float32 attention at each trunk's
    bucket-1024 shape, with the launch's bound: the larger of its float32
    work on the real pairs (4·H·D a pair) at the tensor cores' bf16 rate
    and its real tokens' q, k, v and output (16·H·D bytes a token) at
    HBM3's, as the benchmark's readers count them."""
    rows = []
    with highest_f32_precision():
        for trunk in ATTN_TRUNKS:
            q, k, v, valid, bias, mask = attention_case(trunk, 1024, dev)
            B, H, T, D = q.shape
            n = [int(x) for x in valid.tolist()]
            t_ops = 4 * H * D * sum(x * x for x in n) / BF16_TENSOR_FLOP_PER_S
            t_bytes = 16 * H * D * sum(n) / HBM_BYTES_PER_S
            rows.append(timed_row(
                "attention", lambda: at.attention(q, k, v, valid, bias),
                lambda: at.attention_ref(q, k, v, valid, bias),
                (max(t_ops, t_bytes) * 1e3,
                 "bytes" if t_bytes >= t_ops else "operations"),
                trunk=trunk, B=B, H=H, T=T, D=D,
                pairs_share=at.tile_pairs(n, T) / (B * T * T),
                library_ms=cuda_ms(
                    lambda: library_attention(q, k, v, mask))))
            del q, k, v, mask
            torch.cuda.empty_cache()
    return rows


def phase_attention(dev, smi):
    """Phase 12: returns E2's widest normwise distance to its twin and its
    timed rows (its launches on the main path are phase 11's)."""
    log("phase 12: the trunks' attention (E2) at each bucket's main-path "
        "shape of ESM-2 650M and ProtT5-XL-UniRef50")
    worst = attention_checks(dev)
    rows = attention_times(dev)
    log(f"attention times (CUDA events, mean of 10) on {smi}:")
    for r in rows:
        log(f"  {json.dumps(r)}")
    return worst, rows


def make_handles(dtype: str, dev):
    handles = {}
    for i, (mode, n_labels) in enumerate(MODES.items()):
        cfg = deepfri.GCNConfig(n_labels=n_labels, compute_dtype=dtype)
        g = torch.Generator().manual_seed(SEED + i)
        handles[mode] = ModelHandle(
            "gcn", mode, cfg, deepfri.init_gcn(cfg, g, dev))
    return handles


def run_stream(engine, items, modes=None):
    out = {m: {} for m in (modes or MODES)}

    def collect(part):
        for m, rows in part.items():
            out[m].update(rows)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = engine.predict_stream(iter(items), net="gcn_coords", modes=modes,
                              result_cb=collect)
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


def check_scores(out, items, modes=None):
    """Ids complete, rows of the head's width, finite and in [0, 1]."""
    for m in modes or MODES:
        n_labels = MODES[m]
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


def kernel_bound(name, coords, lengths, D=None, planes=1):
    """(bound_ms, "bytes" | "operations") of one launch on these inputs,
    work counted from the real lengths. B1's products are counted at the
    bf16 tensor-core rate, ``planes`` of them a product (3 for exact
    float32); the distance tests of B2/B3 at the float32 rate."""
    B, L, _ = coords.shape
    n = lengths.clamp(0, L).to(torch.int64)
    sum_n, sum_n2 = int(n.sum()), int((n * n).sum())
    if name == "graphconv_aggregate":
        nbytes = B * L * 13 + B * 4 + 4 * sum_n * D + 4 * B * L * D
        ops, peak = 2 * sum_n2 * D * planes, BF16_TENSOR_FLOP_PER_S
    elif name == "contact_degrees":
        nbytes = B * L * 13 + B * 4 + 4 * B * L
        ops, peak = PAIR_OPS * sum_n2, F32_FLOP_PER_S
    else:  # contact_map: coordinates and lengths in, B·L² floats out
        nbytes = B * L * 12 + B * 4 + 4 * B * L * L
        ops, peak = PAIR_OPS * sum_n2, F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bmm_library_ms(coords, ins, lengths, xs, cdt):
    """B1's library yardstick: one ``torch.bmm`` on the dense adjacency,
    built outside the timed call. float32 with TF32 off; for bfloat16, bf16
    operands with a float32 output where ``bmm`` takes ``out_dtype``, else
    a bf16 output. Returns (ms, output dtype). The port never calls it."""
    adj = aligned_contacts_from_coords(coords, ins, lengths)
    if cdt == "float32":
        with highest_f32_precision():
            return cuda_ms(lambda: torch.bmm(adj, xs)), "float32"
    a, x = adj.to(torch.bfloat16), xs.to(torch.bfloat16)
    try:
        torch.bmm(a, x, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return cuda_ms(lambda: torch.bmm(a, x)), "bfloat16"
    return (cuda_ms(lambda: torch.bmm(a, x, out_dtype=torch.float32)),
            "float32")


def timed_row(name, fn, plain, bound, **fields):
    """CUDA-event ms of ``fn`` (host launch included), the kernel's own
    device ms, host ms (the difference), and the plain twin's ms."""
    ms = cuda_ms(fn)
    device = kernel_device_ms(fn, SYMBOLS[name])
    return {"kernel": name, **fields, "ms": ms, "device_ms": device,
            "host_ms": None if device is None else ms - device,
            "plain_ms": cuda_ms(plain), "bound_ms": bound[0],
            "bound_by": bound[1]}


def kernel_times(dev):
    """B1/B2 and their twins at the main path's shapes (B=TIMED_BATCH), with
    each launch's bound and B1's library yardstick."""
    rows = []
    for L in BUCKETS:
        coords, ins, lengths = (
            torch.from_numpy(a).to(dev)
            for a in synthetic.contact_batch(B=TIMED_BATCH, L=L, seed=L))
        rows.append(timed_row(
            "contact_degrees",
            lambda: gc.contact_degrees(coords, ins, lengths),
            lambda: gc.contact_degrees_ref(coords, ins, lengths),
            kernel_bound("contact_degrees", coords, lengths),
            bucket=L, D=None, dtype="float32", library_ms=None))
        for D in (1024, 512):
            xs = torch.randn((TIMED_BATCH, L, D), device=dev)
            for cdt in ("bfloat16", "float32"):
                lib_ms, lib_dtype = bmm_library_ms(coords, ins, lengths, xs,
                                                   cdt)
                rows.append(timed_row(
                    "graphconv_aggregate",
                    lambda: gc.graphconv_aggregate(coords, ins, lengths, xs,
                                                   compute_dtype=cdt),
                    lambda: gc.graphconv_aggregate_ref(
                        coords, ins, lengths, xs, compute_dtype=cdt),
                    kernel_bound("graphconv_aggregate", coords, lengths, D,
                                 planes=3 if cdt == "float32" else 1),
                    bucket=L, D=D, dtype=cdt, library_ms=lib_ms,
                    library_out_dtype=lib_dtype))
    return rows


def kernel_device_ms(fn, name: str, iters: int = 10) -> float | None:
    """Mean device time of the CUDA kernel ``name`` over ``iters`` calls of
    ``fn``, from ``torch.profiler``; None if two traces show no such
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a trace now and then comes back without the kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if name in e.key]
        if hits:
            return (sum(e.device_time_total for e in hits)
                    / sum(e.count for e in hits) / 1e3)
    return None


def contact_map_times(dev):
    """B3 and its twin at the fine-tuning path's shapes (B=8) and B=32,
    with each launch's bound (no single PyTorch call computes the map)."""
    rows = []
    for B in (FT_BATCH, TIMED_BATCH):
        for L in BUCKETS:
            coords, _, lengths = (
                torch.from_numpy(a).to(dev)
                for a in synthetic.contact_batch(B=B, L=L, seed=L + B))
            rows.append(timed_row(
                "contact_map",
                lambda: contact.contact_map_fused(coords, lengths),
                lambda: contact.batched_contact_maps(coords, lengths),
                kernel_bound("contact_map", coords, lengths),
                B=B, bucket=L, library_ms=None))
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


def finetune_corpus(root: Path) -> dict:
    """Phase 5's seeded corpus and base weights under ``root``: the
    full-width mf GCN config, its terms, the structures, the labels TSV and
    the weights folder."""
    # The ONNX graphs consume the adjacency as fed (as the published ones
    # do), so the imported config has no normalisation.
    cfg = deepfri.GCNConfig(n_labels=FT_TERMS, adj_norm="none", **FT_GCN)
    terms = synthetic.goterms(FT_TERMS)
    structures, labels_path = synthetic.write_training_corpus(
        root, FT_PROTEINS, terms, seed=SEED)
    base = deepfri.init_gcn(cfg, torch.Generator().manual_seed(SEED), "cpu")
    weights = synthetic.write_gcn_weights(root / "weights", cfg, base, terms)
    return {"cfg": cfg, "terms": terms, "structures": structures,
            "labels": labels_path, "weights": weights}


def finetune_run(dev, ft: dict, out: Path, on_step=None):
    """``training.finetune`` of phase 5's settings on ``ft``'s corpus."""
    return training.finetune(
        ft["weights"], "mf", ft["structures"], ft["labels"], out,
        device=dev, epochs=FT_EPOCHS, learning_rate=FT_LR,
        batch_size=FT_BATCH, seed=SEED, on_step=on_step)


def phase_finetune(dev, smi, root: Path):
    """Phase 5: fine-tune the full-width mf GCN in ``root``; returns B3's
    launches and ``ft``: the corpus (:func:`finetune_corpus`) with the
    checkpoint (``ckpt``), the losses, and the run's seconds."""
    ft = finetune_corpus(root)
    cfg, terms, structures, labels_path, weights = (
        ft["cfg"], ft["terms"], ft["structures"], ft["labels"],
        ft["weights"])
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
    ckpt = finetune_run(dev, ft, root / "out",
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
    ft.update(ckpt=ckpt, losses=losses, secs=secs)
    return launches["contact_map"], ft


def fused_modes(engine, bucket: int, modes) -> int:
    """Modes of one GCN batch that run on the fused kernels (3 B1 and 1 B2
    launches each): none for a shared-trunk batch, else those that
    ``resolve_spmm`` sends to "fused" at this bucket."""
    if engine._multi_key(modes):
        return 0
    return sum(resolve_spmm(engine.spmm, bucket,
                            engine.gcn_models[m].config.compute_dtype,
                            engine.device) == "fused" for m in modes)


def gcn_launches(n_fused_modes: int) -> dict:
    return {"graphconv_aggregate": 3 * n_fused_modes,
            "contact_degrees": n_fused_modes, "contact_map": 0}


def expect_launches(got: dict, want: dict, what: str) -> None:
    log(f"  {what}: launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"{what}: kernel launch counts differ")


def require_launches(got: dict, names, what: str) -> None:
    if not all(got[k] > 0 for k in names):
        raise AssertionError(f"{what}: no launch of {names}: {got}")


def no_hit_sequences(n: int, seed: int) -> list:
    """``n`` (id, sequence) CNN items, lengths uniform in P6_SEQ_LENGTHS."""
    rng = np.random.default_rng(seed)
    lo, hi = P6_SEQ_LENGTHS
    return [(f"s{i}", "".join(rng.choice(list(synthetic.AMINO_ACIDS),
                                         size=int(rng.integers(lo, hi + 1)))))
            for i in range(n)]


def near_threshold_terms(n_labels: int) -> int:
    """Terms whose median score sits on the threshold: ``P6_NEAR_TERMS``
    for a head wider than twice that, an eighth of the head otherwise."""
    return (P6_NEAR_TERMS if n_labels > 2 * P6_NEAR_TERMS
            else n_labels // 8)


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


def dense_cmap_items(dev, items, engine) -> list:
    """(id, seq, cmap) items: each protein's adjacency from its projected
    coordinates and insertions as ``engine`` builds it on the card, brought
    to the host as a bool L × L map."""
    out = []
    for qid, seq, proj, ins in items:
        adj = aligned_contacts_from_coords(
            torch.from_numpy(proj)[None].to(dev),
            torch.from_numpy(ins)[None].to(dev),
            torch.tensor([len(seq)], dtype=torch.int32, device=dev),
            engine.contact_threshold, engine.generated_contacts)[0]
        out.append((qid, seq, adj.to(torch.bool).cpu().numpy()))
    return out


def adjacency_bytes(engine, cmap_items) -> list:
    """The uint8 adjacency bytes (batch · bucket²) of each batch that
    ``engine.predict_gcn(cmap_items)`` sends to the card."""
    plan = bucket_plan([len(it[1]) for it in cmap_items], engine.buckets)
    return [batch * bucket * bucket for bucket in sorted(plan)
            for _, batch in engine._chunks(
                bucket, "gcn", [cmap_items[i] for i in plan[bucket]])]


def timed(fn):
    """(result, seconds) of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_models(dev, smi, items, weights):
    """Phase 6: the published model set, written to the folder ``weights``
    (phase 7 reads it again), through the whole engine; every check raises
    on failure. Returns the loaded GCN handles."""
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

    fused = BatchedPredictor(gcn_h, cnn_h, device=dev, batch_cap=BATCH_CAP,
                             spmm="fused")
    dense = BatchedPredictor(gcn_h, cnn_h, device=dev, batch_cap=BATCH_CAP,
                             spmm="dense")
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

    # predict_gcn: the same proteins as dense contact maps (the coordinates
    # path's own adjacency, as bool), through the shared-trunk step (the
    # dense engine) and one dense forward per mode (the fused engine never
    # takes the shared step): torch.bmm on the given uint8 adjacency.
    cmap_items = dense_cmap_items(dev, items, dense)
    reset_launch_counts()
    gcn_multi, _ = timed(lambda: dense.predict_gcn(cmap_items))
    gcn_per_mode, _ = timed(lambda: fused.predict_gcn(cmap_items))
    expect_launches(launch_counts(), {k: 0 for k in launches},
                    "predict_gcn, both routes")
    for out in (gcn_multi, gcn_per_mode):
        check_scores(out, items)
    cmap_diff = {"shared_trunk_vs_coords": max_diff(gcn_multi, dense_out),
                 "per_mode_vs_coords": max_diff(gcn_per_mode, fused_out)}
    u8 = adjacency_bytes(dense, cmap_items)
    log(f"  predict_gcn vs predict_gcn_from_coords: {json.dumps(cmap_diff)}"
        f" (atol {ROUTE_ATOL}); uint8 adjacency to the card: {len(u8)} "
        f"batches, {u8} bytes each, {sum(u8)} in all")
    if not max(cmap_diff.values()) <= ROUTE_ATOL:
        raise AssertionError("predict_gcn differs from the coordinates path")

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

    def per_mode(eng):
        # one request per mode: the dense route then runs no shared step
        return sum(run_stream(eng, items, modes=[m])[2] for m in MODES)

    passes = {
        "fused_per_mode": lambda: run_stream(fused, items)[2],
        "dense_per_mode": lambda: per_mode(dense),
        "dense_multimode": lambda: run_stream(dense, items)[2],
        "predict_gcn_multimode": lambda: timed(
            lambda: dense.predict_gcn(cmap_items))[1],
        "predict_gcn_per_mode": lambda: timed(
            lambda: fused.predict_gcn(cmap_items))[1],
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
    return gcn_h

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


def build_checkout(parent: Path) -> None:
    """The kernels and native libraries of the checkout at ``parent``,
    built before any of its runs is timed."""
    subprocess.run(
        [sys.executable, "-c", "from metagenomic_deepfri_tpu_torch.ops "
         "import _build; from metagenomic_deepfri_tpu_torch.native "
         "import build; _build.build_library(); "
         "[build.build(n) for n in build.NAMES]"],
        cwd=parent, check=True, timeout=P8_FRESH_TIMEOUT)


def inference_gcn_s(log_text: str) -> list:
    """``inference/gcn``'s seconds from a run's ``[profile]`` log lines."""
    return [float(ln.rsplit(": ", 1)[1].split("s")[0])
            for ln in log_text.splitlines()
            if "[profile] inference/gcn: " in ln]


def parent_run_b(parent: Path, argv: list, out: Path, smi) -> None:
    """Run B's command from the checkout at ``parent`` in a fresh process:
    its wall seconds and ``inference/gcn``'s, from its log."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "metagenomic_deepfri_tpu_torch.cli", *argv,
         "-o", str(out), "--skip-matrix"], cwd=parent, capture_output=True,
        text=True, timeout=P7_RUN_B_TIMEOUT)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise AssertionError(f"the parent's run B exited {proc.returncode}")
    log(f"  run B of the parent checkout (fresh process): {secs:.2f} s, "
        f"inference/gcn {inference_gcn_s(proc.stdout)} s on {smi}")
    shutil.rmtree(out, ignore_errors=True)


def phase_predict(dev, smi, weights: Path, root: Path, device_arg: str,
                  parent: Path | None = None):
    """Phase 7: ``predict-function`` end to end through the port's command
    line, in this process (run A) and in a subprocess (run B,
    ``--skip-matrix``); with ``parent``, that checkout's run B before and
    after this one's. Returns run A's kernel launches."""
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

    batches, n_fused = [], []
    real_run_batch = BatchedPredictor._run_batch

    def spy(self, bucket, chunk, batch, modes, net="gcn_coords"):
        batches.append((net, bucket, batch, len(chunk)))
        if net == "gcn_coords":
            n_fused.append(fused_modes(self, bucket, modes))
        return real_run_batch(self, bucket, chunk, batch, modes, net)

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

    if parent:
        parent_run_b(parent, argv, root / "run_b_parent", smi)
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
    log(f"  run B (subprocess, --skip-matrix): {secs_b:.2f} s, "
        f"{n_queries / secs_b:.2f} queries/s end to end, inference/gcn "
        f"{inference_gcn_s(proc.stdout)} s on {smi}")
    if parent:
        parent_run_b(parent, argv, root / "run_b_parent", smi)

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

    # Check 3: 3 B1 and 1 B2 launches per mode of each GCN batch on the
    # fused route (none on the shared-trunk step).
    expect_launches(launches, gcn_launches(sum(n_fused)),
                    f"run A, {len(gcn_batches)} GCN batches, fused modes "
                    f"{n_fused}")

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

    # Check 5: run B (--skip-matrix: the same batches) against run A.
    for name in ("alignment_summary.tsv", "results.tsv"):
        if (out_a / name).read_bytes() != (out_b / name).read_bytes():
            raise AssertionError(f"run B's {name} differs from run A's")
    log("  run B's alignment_summary.tsv and results.tsv: byte-identical "
        "to run A's")
    # Checks 6 and 7.
    n_rows = check_results(out_a, len(MODES))
    log(f"  results.tsv: {n_rows} rows, every mode, all ≥ "
        f"{SCORE_THRESHOLD}, sorted; results_propagated.tsv "
        f"{len(read_tsv(out_a / 'results_propagated.tsv')[1])} rows")
    return launches, (structures, queries, hits, threads)


def percentiles(ms: list) -> dict:
    """p50/p90/p99 of latencies in ms, and their count."""
    return {"n": len(ms), **{f"p{q}": float(np.percentile(ms, q))
                             for q in (50, 90, 99)}}


def run_a_scores(out_a: Path) -> dict:
    """{(protein, network, mode name): {term: score}} of run A's
    results.tsv."""
    _, rows = read_tsv(out_a / "results.tsv")
    out = {}
    for r in rows:
        out.setdefault(tuple(r[:3]), {})[r[3]] = float(r[4])
    return out


def rows_agree(want: dict, have: dict, what) -> float:
    """Same terms with scores within P7_SCORE_ATOL, but a term within that
    of the threshold may be on one side only; returns the largest |Δ|."""
    worst = 0.0
    for term in want.keys() | have.keys():
        if term in want and term in have:
            worst = max(worst, abs(want[term] - have[term]))
            if worst > P7_SCORE_ATOL:
                raise AssertionError(f"{what} {term}: {want[term]} vs "
                                     f"{have[term]}")
        elif (want.get(term) or have.get(term)) > \
                SCORE_THRESHOLD + P7_SCORE_ATOL:
            raise AssertionError(f"{what} {term}: on one side only")
    return worst


def check_response(req: dict, resp: dict, hits: dict, ref: dict) -> float:
    """Phase 8's checks of one response against its request, the hit map
    and run A's rows (``ref``, from :func:`run_a_scores`); returns the
    largest score |Δ| against run A."""
    if "error" in resp:
        raise AssertionError(f"server error: {resp['error']}")
    res, skipped = resp["results"], resp["skipped"]
    if set(res) | set(skipped) != set(req) or set(res) & set(skipped):
        raise AssertionError("response ids differ from the request's")
    worst = 0.0
    for qid, seq in req.items():
        if "U" in seq:
            if skipped.get(qid) != "selenocysteine":
                raise AssertionError(f"{qid}: selenoprotein not skipped")
            continue
        entry = res[qid]
        want_target = hits.get(qid)
        if (entry["aligned"], entry.get("target")) != (
                want_target is not None, want_target):
            raise AssertionError(f"{qid}: aligned to {entry.get('target')}, "
                                 f"want {want_target}")
        if set(entry["scores"]) != set(MODES):
            raise AssertionError(f"{qid}: modes {sorted(entry['scores'])}")
        for mode, rows in entry["scores"].items():
            scores = [s for _, s, _ in rows]
            if scores != sorted(scores, reverse=True) or (
                    scores and min(scores) < SCORE_THRESHOLD):
                raise AssertionError(f"{qid}/{mode}: scores unsorted or "
                                     "below the threshold")
            worst = max(worst, rows_agree(
                ref.get((qid, entry["network"], MODE_NAMES[mode]), {}),
                {t: s for t, s, _ in rows}, f"{qid}/{mode}"))
    return worst


def phase_serve(dev, smi, weights: Path, root: Path, inputs, device_arg: str,
                parent: Path | None = None):
    """Phase 8: the resident annotation server on phase 6's weights and
    phase 7's structures, over its Unix socket, in this process (its
    warmup waited for and its launches counted apart; then a cold
    request, idle single requests, concurrent load; the served rows held
    to run A's results.tsv), then the
    ``serve`` verb in a fresh process (the checkout at ``parent`` too,
    before and after this one's, when given). Returns the B1/B2 launches
    of the phase."""
    with watching_warmups() as warm:
        launches = serve_in_process(dev, smi, weights, root, inputs,
                                    device_arg, warm)
    structures, queries_path, hits, threads = inputs
    checkouts = ([parent, REPO, REPO, parent] if parent else [REPO])
    for cwd in checkouts:
        stats = fresh_serve(cwd, weights, structures, queries_path, hits,
                            threads, device_arg)
        log(f"  fresh-process serve ({'parent' if cwd == parent else 'this'}"
            f" checkout): {json.dumps(stats)} on {smi}")
    return launches


def fresh_serve(cwd: Path, weights: Path, structures: Path, queries_path,
                hits: dict, threads: int, device_arg: str) -> dict:
    """``python -m metagenomic_deepfri_tpu_torch.cli serve`` from the
    checkout at ``cwd`` in a fresh process, with run A's search settings:
    seconds until its socket accepts (a server that warms opens it once
    its warmup has ended), then one cold single-protein request (a hit
    query: the GCN path) sent at once, then ``P8_FRESH_IDLE``
    single-protein requests in sequence; cold and idle milliseconds, the
    seconds from the start to the cold answer, and the engine's warmup
    line from its log where it has one."""
    import socket

    from metagenomic_deepfri_tpu_torch.data.fasta import load_fasta_as_dict
    from metagenomic_deepfri_tpu_torch.serving import annotate_over_socket

    seqs = load_fasta_as_dict(queries_path)
    pool = [q for q in seqs if not q.startswith("long")]
    rng = np.random.default_rng(SEED + 81)
    cold_id = sorted(hits)[0]
    sock_dir = Path(tempfile.mkdtemp())  # Unix socket paths are short
    sock = sock_dir / "s.sock"
    cmd = [sys.executable, "-m", "metagenomic_deepfri_tpu_torch.cli", "serve",
           "-w", str(weights), "-d", str(structures), "--socket", str(sock),
           "--device", device_arg, "-t", str(threads),
           "--mmseqs-max-evalue", "1e-3", "--mmseqs-min-identity", "0.5",
           "--mmseqs-min-coverage", "0.9", "--top-k", "5"]
    for m in MODES:
        cmd += ["-p", m]
    log_path = sock_dir / "serve.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=cwd, stdout=log_file,
                                stderr=subprocess.STDOUT)
    try:
        while True:  # until the socket accepts a connection
            if proc.poll() is not None:
                raise AssertionError(f"serve exited {proc.returncode}:\n"
                                     f"{log_path.read_text()[-4000:]}")
            if time.perf_counter() - t0 > P8_FRESH_TIMEOUT:
                raise AssertionError("the fresh server did not listen")
            try:
                with socket.socket(socket.AF_UNIX) as probe:
                    probe.connect(str(sock))
                break
            except (FileNotFoundError, ConnectionRefusedError):
                time.sleep(0.05)
        listen_s = time.perf_counter() - t0

        def timed_request(qid):
            t = time.perf_counter()
            resp = annotate_over_socket(sock, {qid: seqs[qid]}, timeout=300)
            if qid not in resp["results"] and qid not in resp["skipped"]:
                raise AssertionError(f"fresh serve: {qid} missing")
            return 1e3 * (time.perf_counter() - t)

        cold_ms = timed_request(cold_id)
        idle_ms = [timed_request(str(q)) for q in
                   rng.choice(pool, size=P8_FRESH_IDLE, replace=False)]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        warm_lines = [ln.split("Engine warm: ", 1)[1] for ln in
                      log_path.read_text().splitlines()
                      if "Engine warm: " in ln]
        shutil.rmtree(sock_dir, ignore_errors=True)
    return {"listen_s": listen_s, "cold_request_ms": cold_ms,
            "idle_ms": percentiles(idle_ms),
            "cold_over_idle_p50": cold_ms / float(np.median(idle_ms)),
            "first_answer_s": listen_s + cold_ms / 1e3,
            "warmup": warm_lines[0] if warm_lines else None}


def serve_in_process(dev, smi, weights: Path, root: Path, inputs,
                     device_arg: str, warm: dict) -> dict:
    """Phase 8's server in this process (``warm``: the record of
    :func:`watching_warmups` around it)."""
    from metagenomic_deepfri_tpu_torch.data.fasta import load_fasta_as_dict
    from metagenomic_deepfri_tpu_torch.serving import (AnnotationServer,
                                                       annotate_over_socket)

    structures, queries_path, hits, threads = inputs
    seqs = load_fasta_as_dict(queries_path)
    pool = [q for q in seqs if not q.startswith("long")]
    ref = run_a_scores(root / "run_a")
    rng = np.random.default_rng(SEED + 80)

    def request(n):
        ids = rng.choice(pool, size=n, replace=False)
        return {str(q): seqs[q] for q in ids}

    kw = dict(databases=[structures], processing_modes=list(MODES),
              max_eval=1e-3, min_ident=0.5, min_coverage=0.9, top_k=5,
              threads=threads, device=device_arg)  # run A's search settings
    gcn_batch_modes = []  # modes on the fused kernels in each GCN batch
    real_run_batch = BatchedPredictor._run_batch
    secs = {"engine": 0.0, "passes": 0.0}  # host clock, summed

    def spy(self, bucket, chunk, batch, modes, net="gcn_coords"):
        if net == "gcn_coords":
            gcn_batch_modes.append(fused_modes(self, bucket, modes))
        t = time.perf_counter()
        out = real_run_batch(self, bucket, chunk, batch, modes,
                             net)  # ends with the fetch to the host
        secs["engine"] += time.perf_counter() - t
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    srv = AnnotationServer(weights, **kw)
    up_s = time.perf_counter() - t0
    warm_8 = warmup_report(warm[0]) if warm else {"launches": no_launches()}
    log(f"phase 8: server up in {up_s:.2f} s ({device_arg}, {len(MODES)} "
        f"modes, {threads} threads); its warmup, waited for before the "
        f"first request: {json.dumps(warm_8)} on {smi}")
    expect_launches(launch_counts(), warm_8["launches"],
                    "the server's warmup")
    coalesced = []
    real_drain = srv._drain_once

    def drain(*args, **kwargs):
        t = time.perf_counter()
        n = real_drain(*args, **kwargs)
        if n:
            coalesced.append(n)
            secs["passes"] += time.perf_counter() - t
        return n

    srv._drain_once = drain
    sock_dir = tempfile.mkdtemp()  # Unix socket paths are short
    sock = Path(sock_dir) / "serve.sock"
    ready = threading.Event()
    server_thread = threading.Thread(target=srv.serve_unix,
                                     args=(sock, ready), daemon=True)
    worst = 0.0
    BatchedPredictor._run_batch = spy
    reset_launch_counts()
    try:
        server_thread.start()
        if not ready.wait(30):
            raise AssertionError("the server did not start")

        def timed_request(req):
            t = time.perf_counter()
            resp = annotate_over_socket(sock, req, timeout=300)
            return resp, 1e3 * (time.perf_counter() - t)

        cold_req = request(P8_COLD)
        cold, cold_ms = timed_request(cold_req)
        worst = max(worst, check_response(cold_req, cold, hits, ref))
        idle_ms = []
        for _ in range(P8_IDLE):
            req = request(1)
            resp, ms = timed_request(req)
            worst = max(worst, check_response(req, resp, hits, ref))
            idle_ms.append(ms)
        load_reqs = [request(int(rng.integers(P8_LOAD_SIZES[0],
                                              P8_LOAD_SIZES[1] + 1)))
                     for _ in range(P8_LOAD_REQUESTS)]
        coalesced.clear()
        secs.update(engine=0.0, passes=0.0)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(P8_LOAD_CLIENTS) as ex:
            load = list(ex.map(timed_request, load_reqs))
        load_s = time.perf_counter() - t0
        load_passes, load_secs = list(coalesced), dict(secs)
        for req, (resp, _) in zip(load_reqs, load):
            worst = max(worst, check_response(req, resp, hits, ref))
        # Two passes of the load's first requests, merged as the batcher
        # merges them, in this thread under torch.profiler (CUDA activity
        # only): the device's busy share of a pass. (Profiling the batcher
        # thread's passes from here slowed them ~8x.)
        from torch.profiler import ProfilerActivity, profile

        passes = [{f"r{i}\x1f{q}": seq for i, req in enumerate(
            load_reqs[k:k + P8_LOAD_CLIENTS]) for q, seq in req.items()}
            for k in (0, P8_LOAD_CLIENTS)]
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for merged in passes:
                srv.annotate(merged)
        profiled_s = time.perf_counter() - t0
        busy_s = sum(e.self_device_time_total
                     for e in prof.key_averages()) / 1e6
    finally:
        BatchedPredictor._run_batch = real_run_batch
        srv.shutdown()
        server_thread.join(timeout=30)
        shutil.rmtree(sock_dir, ignore_errors=True)
    launches = launch_counts()
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else float("nan"))
    if server_thread.is_alive():
        raise AssertionError("the server thread did not stop")

    gcn_modes = sum(gcn_batch_modes)
    expect_launches(launches, gcn_launches(gcn_modes),
                    f"phase 8, {len(gcn_batch_modes)} GCN batches "
                    f"({gcn_modes} batch-modes on the fused kernels)")
    load_ms = [ms for _, ms in load]
    n_load = sum(len(r) for r in load_reqs)
    stats = {
        "cold_request_ms": cold_ms, "cold_proteins": P8_COLD,
        "idle_ms": percentiles(idle_ms),
        "load_ms": percentiles(load_ms), "load_requests": len(load_reqs),
        "load_clients": P8_LOAD_CLIENTS, "load_proteins": n_load,
        "load_s": load_s, "load_proteins_per_s": n_load / load_s,
        "load_passes": len(load_passes),
        "mean_requests_per_pass": float(np.mean(load_passes)),
        "load_pass_s": load_secs["passes"],
        "load_engine_s": load_secs["engine"],
        "engine_share_of_passes": load_secs["engine"] / load_secs["passes"],
        "profiled_passes": len(passes), "profiled_s": profiled_s,
        "device_busy_s": busy_s, "device_busy_share": busy_s / profiled_s,
        "peak_device_gib": peak}
    log(f"  served rows vs run A's results.tsv: max|Δ|={worst:.3g} (atol "
        f"{P7_SCORE_ATOL:.4g})")
    log(f"  serving {json.dumps(stats)} on {smi}")
    return plus(launches, warm_8["launches"])


def nw_pairs(seed: int):
    """(query, 25 targets, gap open, gap extend) for 8 seeded queries: 200
    pairs of lengths 1–300, every fifth target a near-copy."""
    rng = np.random.default_rng(seed)
    aas = list(synthetic.AMINO_ACIDS)
    gaps = [(10, 1), (11, 1), (5, 2)]
    for i in range(8):
        q = "".join(rng.choice(aas, size=int(rng.integers(1, 301))))
        targets = []
        for j in range(25):
            if j % 5 == 0:
                t = list(q)
                for pos in rng.choice(len(q), size=len(q) // 5,
                                      replace=False):
                    t[pos] = rng.choice(aas)
                targets.append("".join(t))
            else:
                targets.append("".join(rng.choice(
                    aas, size=int(rng.integers(1, 301)))))
        yield (q, targets, *gaps[i % 3])


def trace_kernel_names(trace_dir: Path) -> set:
    """Names of the CUDA kernel events in the Chrome traces of a dir."""
    names = set()
    for path in trace_dir.glob("*.json"):
        for e in json.loads(path.read_text())["traceEvents"]:
            if e.get("cat") == "kernel":
                names.add(e.get("name", ""))
    return names


def phase_bench(dev, smi, kind: str, root: Path, device_arg: str):
    """Phase 9: the ``benchmark`` verb through ``cli.main`` (its kernel
    launches returned), the multi-mode, roofline, CNN and spmm-matrix
    measurements of ``bench_utils``, one pass under ``torch_trace``, and
    the device NW against the host NW."""
    import contextlib
    import io

    from metagenomic_deepfri_tpu_torch import cli, profiling
    from metagenomic_deepfri_tpu_torch.align.matrices import ScoringMatrix
    from metagenomic_deepfri_tpu_torch.ops.nw import (nw_score_many,
                                                      nw_score_many_device)

    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["benchmark", "--bucket", str(P9_BUCKET),
                           "--batches", str(P9_BATCHES), "--device",
                           device_arg])
    finally:
        logging.getLogger().handlers.clear()
    launches = launch_counts()
    secs = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"benchmark verb: exit {rc}, {len(lines)} JSON "
                             "lines")
    line = json.loads(lines[0])
    log(f"phase 9: benchmark verb ({secs:.2f} s, launches {launches}) on "
        f"{smi}:")
    log(lines[0])
    mfu = line["detail"]["mfu"]
    if line["detail"]["device"] != kind or not (
            line["value"] > 0 and mfu is not None and 0 < mfu <= 1):
        raise AssertionError("benchmark verb: device or MFU out of range")
    reset_launch_counts()
    t0 = time.perf_counter()
    dense_line = bench_utils.run_gcn_benchmark(
        bucket=P9_BUCKET, batches=P9_DENSE_BATCHES, path="dense", device=dev)
    log(f"  run_gcn_benchmark(path=\"dense\") ({time.perf_counter() - t0:.2f}"
        f" s) on {smi}, beside the verb's coords line above:")
    log(dense_line)
    expect_launches(launch_counts(), {k: 0 for k in launches},
                    "the dense-cmap benchmark (torch.bmm)")
    dense_detail = json.loads(dense_line)["detail"]
    if dense_detail["path"] != "dense" or not json.loads(dense_line)[
            "value"] > 0:
        raise AssertionError("the dense-cmap benchmark line")

    for name, fn in (
            ("multimode", lambda: bench_utils.run_multimode_benchmark(
                bucket=P9_BUCKET, batches=1, reps=2, device=dev)),
            ("roofline", lambda: bench_utils.run_roofline_benchmark(
                bucket=P9_BUCKET, reps=4, device=dev)),
            ("cnn", lambda: bench_utils.run_cnn_benchmark(
                bucket=P9_BUCKET, batches=2, device=dev))):
        t0 = time.perf_counter()
        out = fn()
        log(f"  {name} ({time.perf_counter() - t0:.2f} s) on {smi}: {out}")
        if not json.loads(out)["value"] > 0:
            raise AssertionError(f"{name}: no positive rate")

    t0 = time.perf_counter()
    matrix = json.loads(bench_utils.run_spmm_matrix(
        buckets=P9_MATRIX_BUCKETS, reps=2, device=dev))
    log(f"  spmm matrix ({time.perf_counter() - t0:.2f} s, reps 2) on {smi}: "
        f"{json.dumps(matrix['detail'])}")
    if matrix["detail"]["errors"]:
        raise AssertionError("spmm matrix: a cell failed")
    for key, route in matrix["detail"]["auto_table"].items():
        bucket, dtype = key.split(",")
        table = resolve_spmm("auto", int(bucket), dtype, torch.device("cuda"))
        log(f"    {key}: this run {route}, AUTO_SPMM_TABLE {table}"
            f"{'' if route == table else ' (differs; not fatal)'}")

    trace_dir = root / "trace"
    with profiling.torch_trace(trace_dir):
        bench_utils.device_only_gcn_pps(bucket=128, reps=1, batch_cap=32,
                                        spmm="fused", device=dev)
    names = trace_kernel_names(trace_dir)
    log(f"  torch_trace: {len(names)} CUDA kernel names in "
        f"{[p.name for p in trace_dir.glob('*.json')]}")
    if not any(SYMBOLS["graphconv_aggregate"] in n for n in names):
        raise AssertionError("torch_trace: no CUDA kernel events of B1")

    sm = ScoringMatrix.from_name("BLOSUM62")
    t0 = time.perf_counter()
    n_pairs = 0
    for q, targets, go, ge in nw_pairs(SEED + 90):
        got = nw_score_many_device(q, targets, sm, go, ge, device=dev)
        if not np.array_equal(got, nw_score_many(q, targets, sm, go, ge)):
            raise AssertionError("device NW differs from the host NW")
        n_pairs += len(targets)
    log(f"  device NW = host NW on {n_pairs} pairs "
        f"({time.perf_counter() - t0:.2f} s)")
    return launches


def launches_since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def kernels_on_every_card(devices) -> None:
    """B1/B2/B3 on each listed card against their twins there (the kernels'
    per-device state: the current device is entered per launch)."""
    g = torch.Generator().manual_seed(SEED)
    batch = synthetic.contact_batch(B=4, L=512, seed=SEED + 7)
    xs_host = torch.randn((4, 512, 200), generator=g)
    for d in devices:
        dev = torch.device(d)
        coords, ins, lengths = (torch.from_numpy(a).to(dev) for a in batch)
        xs = xs_host.to(dev)
        pairs = {
            "contact_map": (contact.contact_map_fused(coords, lengths),
                            contact.batched_contact_maps(coords, lengths)),
            "contact_degrees": (gc.contact_degrees(coords, ins, lengths),
                                gc.contact_degrees_ref(coords, ins,
                                                       lengths)),
            "graphconv_aggregate": (
                gc.graphconv_aggregate(coords, ins, lengths, xs),
                gc.graphconv_aggregate_ref(coords, ins, lengths, xs))}
        torch.cuda.synchronize(dev)
        errs = {}
        for name, (got, ref) in pairs.items():
            if got.device != dev:
                raise AssertionError(f"{name} ran on {got.device}, not {dev}")
            errs[name] = (got - ref).abs().max().item()
            tol = (dict(AGG_TOL) if name == "graphconv_aggregate"
                   else dict(rtol=0, atol=0))
            torch.testing.assert_close(got, ref, **tol)
        log(f"  kernels on {dev}: max|Δ| {json.dumps(errs)}")


def counting_batches(engine) -> list:
    """(bucket, modes) of every batch ``engine`` runs from now on."""
    seen = []
    real = engine._run_batch

    def spy(bucket, chunk, batch, modes, *args, **kwargs):
        seen.append((bucket, tuple(modes)))
        return real(bucket, chunk, batch, modes, *args, **kwargs)

    engine._run_batch = spy
    return seen


def multi_engine(devices, gcn_h, items, smi) -> None:
    """Phase 10 (a): the data-parallel engine over ``devices`` against the
    one-card engine, on the fused route (mf) and under "auto" (3 modes,
    shared trunk); launches checked per batch and card."""
    catalogue = bench_utils.make_random_items(
        P10_CATALOGUE, *P10_CATALOGUE_LENGTHS, seed=SEED + 40, form="coords")
    work = items + catalogue
    rates = {}
    for label, modes, spmm in (("fused, mf", ["mf"], "fused"),
                               ("auto, bp/cc/mf", list(MODES), "auto")):
        engines = {"one": BatchedPredictor(gcn_h, device=devices[:1],
                                           spmm=spmm),
                   "all": BatchedPredictor(gcn_h, device=devices,
                                           spmm=spmm)}
        outs = {}
        for key, eng in engines.items():
            seen = counting_batches(eng)
            before = launch_counts()
            outs[key], n, _ = run_stream(eng, work, modes=modes)
            want = gcn_launches(len(eng.devices) * sum(
                fused_modes(eng, b, list(m)) for b, m in seen))
            expect_launches(launches_since(before), want,
                            f"(a) {label}, {len(eng.devices)} card(s), "
                            f"{len(seen)} batches")
            if n != len(work):
                raise AssertionError(f"processed {n} of {len(work)}")
            check_scores(outs[key], work, modes)
        diff = max_diff(outs["one"], outs["all"])
        log(f"  (a) {label}: {len(devices)} cards vs one, {len(work)} "
            f"proteins: max|Δ|={diff:.3g} (atol {ROUTE_ATOL})")
        if not diff <= ROUTE_ATOL:
            raise AssertionError("the data-parallel engine differs from "
                                 "the one-card engine")
        samples = {key: [] for key in engines}
        for _ in range(P10_ROUNDS):
            for key, eng in engines.items():
                samples[key].append(run_stream(eng, work, modes=modes)[2])
        rates[label] = {f"{len(eng.devices)}_cards_proteins_per_s":
                        len(work) / float(np.median(samples[key]))
                        for key, eng in engines.items()}
    log(f"  (a) warm passes, median of {P10_ROUNDS} in turns, "
        f"{len(work)} proteins (phase 4's and a bucket-512 catalogue of "
        f"{P10_CATALOGUE}), float32, engine batch sizes: "
        f"{json.dumps(rates)} on {smi}")


def normwise_tree_err(a: dict, b: dict) -> float:
    """Worst leaf of max |a - b| / max |b| over two numpy trees."""
    fa, fb = registry._flatten(a), registry._flatten(b)
    if fa.keys() != fb.keys():
        raise AssertionError("checkpoint trees differ in structure")
    return max(float(np.abs(fa[k] - fb[k]).max()
                     / max(np.abs(fb[k]).max(), 1e-300)) for k in fa)


def multi_finetune(devices, ft: dict, root: Path, smi) -> None:
    """Phase 10 (b): phase 5's fine-tuning over one rank a card (model axis
    2 on an even count). The first step's loss and gradients over the ranks
    are held to one card's (normwise, ``GRAD_RTOL``); the whole run's
    checkpoint and losses to phase 5's: exactly on one card, reported on
    several (Adam turns reduction-order rounding in near-zero gradient
    entries into whole steps of the learning rate, and the saturated
    synthetic heads amplify it over the run)."""
    n = len(devices)
    mp = 2 if n >= 2 and n % 2 == 0 else 1
    dev0 = torch.device(devices[0])
    cfg = ft["cfg"]
    base = load_model_handle("gcn", "mf", next(ft["weights"].glob("*.onnx")),
                             next(ft["weights"].glob("*_model_params.json")))
    dataset = training.FineTuneDataset(
        ft["structures"], training.load_labels(ft["labels"], ft["terms"]))
    batch = next(dataset.iter_batches(FT_BATCH, np.random.default_rng(SEED),
                                      "cpu"))
    loss, grads = train.value_and_grad(
        devices, cfg, base.params, [t.numpy() for t in batch],
        model_parallel=mp)
    ref = loss_and_grads(base.params, cfg, [t.to(dev0) for t in batch], dev0)
    got = [torch.tensor(loss)] + [torch.from_numpy(g) for g in
                                  train.param_leaves(grads)]
    step_err = max(normwise_err(g, r.cpu())
                   for g, r in zip(got, ref, strict=True))
    log(f"  (b) first step over {n} rank(s), data {n // mp} x model {mp}: "
        f"loss and gradients vs one card normwise {step_err:.3g} (rtol "
        f"{GRAD_RTOL})")
    if not step_err <= GRAD_RTOL:
        raise AssertionError("multi-card gradients differ from one card")

    losses = []
    before = launch_counts()
    t0 = time.perf_counter()
    ckpt = training.finetune(
        ft["weights"], "mf", ft["structures"], ft["labels"],
        root / "out_multi", device=devices, epochs=FT_EPOCHS,
        learning_rate=FT_LR, batch_size=FT_BATCH, seed=SEED,
        model_parallel=mp, on_step=lambda i, loss: losses.append(float(loss)))
    secs = time.perf_counter() - t0
    expect_launches(launches_since(before), {
        "graphconv_aggregate": 0, "contact_degrees": 0,
        "contact_map": len(losses) * n},
        f"(b) {len(losses)} steps on {n} rank(s), B3 a step a rank")
    tuned_cfg, params = registry.load_checkpoint(ckpt)
    ref_cfg, ref_params = registry.load_checkpoint(ft["ckpt"])
    if tuned_cfg != ref_cfg:
        raise AssertionError("multi-card checkpoint config differs")
    err = normwise_tree_err(params, ref_params)
    ref_losses = np.asarray(ft["losses"], np.float64)
    loss_rel = np.abs(np.asarray(losses) - ref_losses) / np.abs(ref_losses)
    log(f"  (b) finetune over {n} rank(s), batch {FT_BATCH}, "
        f"{len(losses)} steps: checkpoint vs one card normwise {err:.3g}; "
        f"losses rel per step {[float(f'{x:.3g}') for x in loss_rel]}; "
        f"{secs:.2f} s, {secs / len(losses):.4f} s/step with rank start-up "
        f"and loading (one card, phase 5: "
        f"{ft['secs'] / len(ref_losses):.4f}) on {smi}")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite multi-card training loss")
    if not loss_rel[0] <= GRAD_RTOL:
        raise AssertionError("multi-card first loss differs from one card")
    if n == 1 and (err != 0.0 or loss_rel.max() != 0.0):
        raise AssertionError("a world of one differs from the one-card run")


def multi_graph(devices, smi) -> None:
    """Phase 10 (c): the graph-sharded forward at L 4096 over one rank a
    card, against ``gcn_forward`` on the dense adjacency on one card."""
    n = len(devices)
    cfg = deepfri.GCNConfig(n_labels=FT_TERMS, **P10_GCN)
    params = gcn_params_to_numpy(deepfri.init_gcn(
        cfg, torch.Generator().manual_seed(SEED + 50), "cpu"))
    coords, ins, _ = bench_utils.random_walk_batch(len(P10_LENGTHS), P10_L,
                                                   SEED + 51)
    lengths = np.asarray(P10_LENGTHS, np.int32)
    tokens = np.random.default_rng(SEED + 52).integers(
        1, 21, coords.shape[:2]).astype(np.uint8)
    dev0 = torch.device(devices[0])
    base = torch.cuda.memory_allocated(dev0)
    torch.cuda.reset_peak_memory_stats(dev0)
    p0 = gcn_params_from_numpy(params, dev0)
    t, c, i, ln = (torch.from_numpy(a).to(dev0)
                   for a in (tokens, coords, ins, lengths))

    def dense():
        return deepfri.gcn_forward(
            p0, cfg, t, aligned_contacts_from_coords(c, i, ln), ln)

    with torch.no_grad():
        ref = dense().cpu().numpy()
        dense_ms = 1e3 * float(np.mean([timed(dense)[1]
                                        for _ in range(P10_REPS)]))
    dense_gib = (torch.cuda.max_memory_allocated(dev0) - base) / 2**30
    before = launch_counts()
    ring = bench_utils.graph_forward_timing(devices, cfg, params, tokens,
                                            coords, ins, lengths,
                                            reps=P10_REPS)
    expect_launches(launches_since(before), {
        "graphconv_aggregate": 0, "contact_map": 0,
        "contact_degrees": (2 + P10_REPS) * n},
        f"(c) {2 + P10_REPS} forwards on {n} rank(s), B2 once each")
    err = float(np.abs(ring["scores"] - ref).max())
    log(f"  (c) graph-sharded forward, {len(lengths)} proteins at L {P10_L} "
        f"(lengths {list(P10_LENGTHS)}), float32, {n} rank(s): max|Δ| vs "
        f"the dense forward on one card {err:.3g} (atol {SLICE_ATOL}); ms a "
        f"forward {[round(m, 2) for m in ring['ms']]} (dense one card "
        f"{dense_ms:.2f}); peak GiB a rank "
        f"{[b and round(b / 2**30, 3) for b in ring['peak_bytes']]} (dense one "
        f"card {dense_gib:.3f}) on {smi}")
    if not err <= SLICE_ATOL:
        raise AssertionError("the graph-sharded forward differs from the "
                             "dense forward")


def phase_multi(devices, smi, gcn_h, items, ft: dict, root: Path) -> dict:
    """Phase 10: several cards. Returns the phase's launches, every rank's
    included."""
    n = len(devices)
    root.mkdir(parents=True, exist_ok=True)
    log(f"phase 10: {n} card(s) {devices}, "
        + ("a world of 1: the ring makes no exchange and every collective "
           "spans one rank" if n == 1 else
           f"a world of {n}: one NCCL rank (or engine replica) a card"))
    try:
        launch.device_list([f"cuda:{i}" for i in range(n + 1)])
    except ValueError as err:
        log(f"  {n + 1} ranks on {n} card(s) raise: {err}")
    else:
        raise AssertionError("a device list beyond the cards did not raise")
    kernels_on_every_card(devices)
    reset_launch_counts()
    multi_engine(devices, gcn_h, items, smi)
    multi_finetune(devices, ft, root, smi)
    multi_graph(devices, smi)
    before = launch_counts()
    t0 = time.perf_counter()
    line = bench_utils.run_mesh_benchmark(devices, root / "mesh.json")
    got = launches_since(before)
    log(f"  (d) run_mesh_benchmark ({time.perf_counter() - t0:.2f} s, "
        f"launches {got}) on {smi}:")
    log(line)
    for row in json.loads((root / "mesh.json").read_text())[
            "data_parallel_fixed_work"]["rows"]:
        log(f"    dp {json.dumps(row)}")
    for row in json.loads((root / "mesh.json").read_text())[
            "graph_ring_fixed_L"]["rows"]:
        log(f"    ring {json.dumps(row)}")
    require_launches(got, ("graphconv_aggregate", "contact_degrees"),
                     "(d) the fused engine rows")
    return launch_counts()


def multi_only(dev, smi, kind, devices) -> int:
    """``--multi-only``: phase 10 and what it is compared with (phase 5's
    one-card fine-tuning, phase 6's model set made without its ONNX round
    trip), for a call on several cards."""
    items = synthetic.aligned_items(N_PROTEINS, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ft = finetune_corpus(root / "ft")
        losses = []
        t0 = time.perf_counter()
        ft["ckpt"] = finetune_run(dev, ft, root / "ft" / "out",
                                  on_step=lambda i, loss: losses.append(
                                      float(loss)))
        ft.update(losses=np.asarray(losses), secs=time.perf_counter() - t0)
        gcn_h, _ = model_set_params(dev, items,
                                    no_hit_sequences(P6_SEQS, SEED))
        launches = phase_multi(devices, smi, gcn_h, items, ft,
                               root / "multi")
    log(json.dumps({"phase_10_launches": launches}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Drive the port's main path on the GPU and check it.")
    parser.add_argument(
        "--multi-only", action="store_true",
        help="Run phases 1, 2 and 10 only, with phase 10's references "
             "(for a call on several cards).")
    parser.add_argument(
        "--parent", type=Path, default=None,
        help="A checkout of another commit: phases 7 and 8 also run its "
             "run B and its serve verb in fresh processes, before and after "
             "this checkout's.")
    args = parser.parse_args(argv)
    # Phase 1: device.
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port's main path needs a GPU")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
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
    check_hgmma(lib_path)
    if args.multi_only:
        return multi_only(dev, smi, kind, devices)

    # Phase 3: kernels against their plain twins.
    log("phase 3: kernels vs plain twins")
    errors = phase_kernels(dev)

    # Phase 4: the slice at full width.
    items = synthetic.aligned_items(N_PROTEINS, seed=SEED)
    handles = {dt: make_handles(dt, dev) for dt in ("bfloat16", "float32")}
    engines = {dt: BatchedPredictor(h, device=dev, batch_cap=BATCH_CAP,
                                    spmm="fused")
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

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # Phase 5: the fine-tuning path (B3 builds each batch's adjacency).
        launches["contact_map"], ft = phase_finetune(dev, smi, root / "ft")
        cmap_times = contact_map_times(dev)
        log(f"contact_map times (CUDA events, mean of 10) on {smi}:")
        for r in cmap_times:
            log(f"  {json.dumps(r)}")
        # Phase 6: the published model set, both networks, both GCN routes.
        weights = root / "weights"
        gcn_h = phase_models(dev, smi, items, weights)
        # Phase 7: predict-function end to end (B1/B2 in every GCN batch).
        if args.parent:
            build_checkout(args.parent)
        p7_launches, p7_inputs = phase_predict(dev, smi, weights, root,
                                               "cuda", args.parent)
        # Phase 8: the resident server over its socket (B1/B2 again), and
        # the serve verb in a fresh process.
        p8_launches = phase_serve(dev, smi, weights, root, p7_inputs, "cuda",
                                  args.parent)
        # Phase 9: the benchmark verb (its launches), bench_utils, NW.
        p9_launches = phase_bench(dev, smi, kind, root, "cuda")
        # Phase 10: every card: the data-parallel engine, fine-tuning over
        # ranks, the graph-sharded forward, the scaling rows.
        p10_launches = phase_multi(devices, smi, gcn_h, items, ft,
                                   root / "multi")
        for counts in (p7_launches, p8_launches, p9_launches, p10_launches):
            for name, n in counts.items():
                launches[name] += n

    # Phase 11: the trunks' projections on E1, alone and on the main path
    # (E2's launches there too).
    (errors["esm_gemm"], esm_times, launches["esm_gemm"],
     launches["attention"]) = phase_esm(dev, smi)
    # Phase 12: the trunks' attention on E2.
    errors["attention"], attn_times = phase_attention(dev, smi)

    def headline(name, shape):
        if name == "contact_map":  # the fine-tuning batch: B=8, bucket 512
            return next(r for r in cmap_times if r["B"] == FT_BATCH
                        and r["bucket"] == 512)
        if name == "esm_gemm":  # the (trunk, projection) named
            return next(r for r in esm_times
                        if (r["trunk"], r["proj"]) == shape)
        if name == "attention":  # the trunk named, at bucket 1024
            return next(r for r in attn_times if r["trunk"] == shape[0])
        return next(r for r in times if r["kernel"] == name
                    and r["bucket"] == 512 and r["dtype"] == "float32"
                    and r["D"] in (None, 1024))

    # E1 three times: ESM-2's fc1 (the widest of its four), ProtT5's wo (K
    # 16,384, no bias, the residual add) and ESM C's fc1 (the gated
    # SwiGLU store); E2 at each trunk's bucket 1024.
    summary = {"kernels": [
        {"name": name, **({"shape": " ".join(shape)} if shape else {}),
         "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errors[name],
         **{k: headline(name, shape)[k] for k in (
             "ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for name, shape in (("graphconv_aggregate", None),
                            ("contact_degrees", None), ("contact_map", None),
                            ("esm_gemm", ("esm2", "fc1")),
                            ("esm_gemm", ("prott5", "wo")),
                            ("esm_gemm", ("esmc", "fc1")),
                            ("attention", ("esm2", "bucket-1024")),
                            ("attention", ("prott5", "bucket-1024")))]}
    log(json.dumps(summary))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
