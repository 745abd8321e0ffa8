#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure exits non-zero:

1. Device: a CUDA device is required (no CPU fallback); prints its name,
   the device count and ``nvidia-smi``'s name and power limit.
2. Build: compiles ``metagenomic_deepfri_tpu_torch/csrc/*.cu`` with nvcc.
3. Kernels against their plain PyTorch twins on the card, at B=4,
   L ∈ {130, 512} (sentinels and insertions) plus a near-threshold batch
   (pairs at 6 Å ± 1 ulp): degrees exact, aggregation rtol 1e-5 / atol 1e-4
   for D ∈ {48, 512, 1024} in float32 and bfloat16 compute.
4. The slice at full published width: three GCN modes (bp 3992, cc 320,
   mf 489 terms; LSTM-LM 512×2, embed 1024, GraphConv 512×3, FC 1024) with
   seeded random weights, 96 alignment-projected proteins of length 40–500,
   through ``BatchedPredictor(device="cuda").predict_stream`` in bfloat16
   and float32. Checks ids, finiteness, range, kernel launch counts, and
   the float32 scores against the dense plain route on the card
   (atol 1e-4). Times a warm pass (proteins/s), the forward's stage shares,
   and each kernel against its twin at the main path's shapes.
5. Prints the kernel summary, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

try:
    from metagenomic_deepfri_tpu_torch import synthetic
    from metagenomic_deepfri_tpu_torch.batching.buckets import (
        assign_bucket, gcn_batch_size)
    from metagenomic_deepfri_tpu_torch.batching.engine import (
        BatchedPredictor, ModelHandle, _pad_batch_coords)
    from metagenomic_deepfri_tpu_torch.models import deepfri
    from metagenomic_deepfri_tpu_torch.models.lstm import lstm_stack_forward
    from metagenomic_deepfri_tpu_torch.ops import _build
    from metagenomic_deepfri_tpu_torch.ops import graphconv as gc
    from metagenomic_deepfri_tpu_torch.ops.one_hot import tokens2onehot
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
SOURCE = "metagenomic_deepfri_tpu_torch/csrc/graphconv.cu"
REPLACES = {
    "contact_degrees": "metagenomic_deepfri_tpu/ops/graphconv_pallas.py:190",
    "graphconv_aggregate":
        "metagenomic_deepfri_tpu/ops/graphconv_pallas.py:275",
}


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


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
    err = {"contact_degrees": 0.0, "graphconv_aggregate": 0.0}
    for name, (coords, ins, lengths) in cases:
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


def run_stream(engine, items):
    out = {m: {} for m in MODES}

    def collect(part):
        for m, rows in part.items():
            out[m].update(rows)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = engine.predict_stream(iter(items), net="gcn_coords",
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


def check_scores(out, items):
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

    gc.reset_launch_counts()
    results = {dt: run_stream(eng, items) for dt, eng in engines.items()}
    launches = {"contact_degrees": gc.contact_degrees.launches,
                "graphconv_aggregate": gc.graphconv_aggregate.launches}
    want = {"contact_degrees": 2 * len(MODES) * n_batches,
            "graphconv_aggregate": 2 * 3 * len(MODES) * n_batches}
    log(f"  launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError("kernel launch counts differ from expected")
    for dt, (out, n, secs) in results.items():
        if n != N_PROTEINS:
            raise AssertionError(f"{dt}: processed {n} of {N_PROTEINS}")
        check_scores(out, items)
        log(f"  {dt}: first pass {secs:.2f} s (includes warm-up)")

    dense = BatchedPredictor(handles["float32"], device=dev,
                             batch_cap=BATCH_CAP, spmm="dense")
    gc.reset_launch_counts()
    dense_out, _, _ = run_stream(dense, items)
    if gc.contact_degrees.launches or gc.graphconv_aggregate.launches:
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

    def headline(name):
        return next(r for r in times if r["kernel"] == name
                    and r["bucket"] == 512 and r["dtype"] == "float32"
                    and r["D"] in (None, 1024))

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errors[name], "ms": headline(name)["ms"],
         "plain_ms": headline(name)["plain_ms"]}
        for name in ("graphconv_aggregate", "contact_degrees")]}
    log(json.dumps(summary))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
