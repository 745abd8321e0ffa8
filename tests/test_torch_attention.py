"""The trunks' attention (``ops/attention.py``) on the CPU: E2's plain twin
against float64 attention at tiny ESM-2- and ProtT5-like shapes (ragged
valid counts of 1, 2 and the full length), ProtT5's int8 bucket table
against T5's buckets and the (H, T, T) gather it replaces at every length
the engine's buckets make, padded query rows finite and real rows
independent of padding, the dispatch, the ``pairs`` arithmetic and the
sdpa spans' counters. The kernel itself is held on the card by
``tests/test_torch_cuda.py``.

Tolerances: the twin computes in float32 against a float64 numpy
reference; logits, weights and values of order 1 over at most 37 keys
agree to float32 rounding, a few 1e-7, asserted within 2e-6.
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from metagenomic_deepfri_tpu_torch import profiling
from metagenomic_deepfri_tpu_torch.models import esm2, prott5
from metagenomic_deepfri_tpu_torch.ops import attention as at
from metagenomic_deepfri_tpu_torch.precision import (highest_f32_precision,
                                                     use_highest_f32_precision)

TOL = 2e-6
# (heads, head dim, bias): ESM-2-like (no bias) and ProtT5-like (T5's).
SHAPES = {"esm2": (3, 64, False), "prott5": (4, 128, True)}
T5 = prott5.ProtT5Config()


def _inputs(kind, B, T, seed):
    H, D, biased = SHAPES[kind]
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(3, B, T, H, D))
    qkv[0] *= D ** -0.5   # logits of order 1, as both trunks' are
    qkv = qkv.astype(np.float32)
    # Views of one (B, T, 3, H, D) projection output, as the trunks make.
    fused = torch.from_numpy(np.ascontiguousarray(qkv.transpose(1, 2, 0, 3,
                                                                4)))
    q, k, v = fused.permute(2, 0, 3, 1, 4)
    bias = None
    if biased:
        rel = torch.from_numpy(rng.normal(size=(T5.buckets, H))
                               .astype(np.float32))
        bias = (rel, prott5.distance_buckets(T5, T, "cpu"))
    return q, k, v, bias


def _float64(q, k, v, valid, bias):
    """softmax(q·kᵀ + bias)·v in float64 numpy, row by row and head by
    head, over each row's valid keys."""
    q, k, v = (t.double().numpy() for t in (q, k, v))
    B, H, T, D = q.shape
    full = None
    if bias is not None:
        rel, _ = bias
        pos = np.arange(T)
        rows = prott5.relative_position_bucket(
            torch.from_numpy(pos[None, :] - pos[:, None])).numpy()
        full = rel.double().numpy()[rows].transpose(2, 0, 1)
    out = np.zeros((B, T, H, D))
    for b in range(B):
        n = int(valid[b])
        for h in range(H):
            s = q[b, h] @ k[b, h, :n].T
            if full is not None:
                s = s + full[h, :, :n]
            w = np.exp(s - s.max(-1, keepdims=True))
            out[b, :, h] = (w / w.sum(-1, keepdims=True)) @ v[b, h, :n]
    return out.reshape(B, T, H * D)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_twin_against_float64_ragged(kind):
    """Rows of 1, 2 and every valid token, and one between, against
    float64: every query row (padded ones too) agrees."""
    T = 37
    q, k, v, bias = _inputs(kind, 4, T, seed=1)
    valid = torch.tensor([1, 2, T, 20])
    got = at.attention_ref(q, k, v, valid, bias)
    H, D, _ = SHAPES[kind]
    assert got.shape == (4, T, H * D) and got.dtype == torch.float32
    want = _float64(q, k, v, valid, bias)
    assert np.abs(got.double().numpy() - want).max() < TOL
    # One valid key: each query's output is that key's value.
    assert torch.allclose(got[0].view(T, H, D),
                          v[0, :, 0][None].expand(T, H, D), atol=0)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_twin_in_float64(kind):
    """In float64 the twin is float64 attention, to float64 rounding."""
    q, k, v, bias = _inputs(kind, 2, 30, seed=2)
    valid = torch.tensor([30, 9])
    got = at.attention_ref(q.double(), k.double(), v.double(), valid, bias)
    assert got.dtype == torch.float64
    want = _float64(q, k, v, valid, bias)
    assert np.abs(got.numpy() - want).max() < 1e-13


@pytest.mark.parametrize("T", [130, 258, 514, 1026, 129, 257, 513, 1025])
def test_bucket_table_is_t5s_gather_at_every_bucket_length(T):
    """The int8 table at ESM-2's (L + 2) and ProtT5's (L + 1) token
    lengths of buckets 128-1024: each distance's entry is T5's bucket, and
    R gathered through it is the (1, H, T, T) bias the trunk gathered
    before, bit for bit."""
    table = prott5.distance_buckets(T5, T, "cpu")
    assert table.dtype == torch.int8 and table.shape == (2 * T - 1,)
    dist = torch.arange(1 - T, T)
    assert torch.equal(table.long(),
                       prott5.relative_position_bucket(dist, T5.buckets,
                                                       T5.max_distance))
    rel = torch.randn(T5.buckets, T5.heads,
                      generator=torch.Generator().manual_seed(T))
    pos = torch.arange(T)
    before = rel[prott5.relative_position_bucket(
        pos[None, :] - pos[:, None])].permute(2, 0, 1)[None].contiguous()
    assert torch.equal(at._bias_of((rel, table), T, torch.float32)[None],
                       before)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_padded_rows_finite_and_real_rows_independent_of_padding(kind):
    """Real rows are the same with more padding behind them, whatever the
    padded positions hold (here values of 1e4); padded query rows are
    finite."""
    H, D, _ = SHAPES[kind]
    q, k, v, _ = _inputs(kind, 2, 64, seed=3)
    valid = torch.tensor([20, 2])
    short = [t[:, :, :24].clone() for t in (q, k, v)]
    for t in (q, k, v):
        t[:, :, 24:] = 1e4
    bias_long = bias_short = None
    if SHAPES[kind][2]:
        rel = torch.randn(T5.buckets, H,
                          generator=torch.Generator().manual_seed(4))
        bias_long = (rel, prott5.distance_buckets(T5, 64, "cpu"))
        bias_short = (rel, prott5.distance_buckets(T5, 24, "cpu"))
    long = at.attention_ref(q, k, v, valid, bias_long)
    alone = at.attention_ref(*short, valid, bias_short)
    assert torch.isfinite(long).all()
    for b, n in enumerate(valid.tolist()):
        assert torch.allclose(long[b, :n], alone[b, :n], rtol=0, atol=1e-6)


def _fake_cuda(dtype=torch.float32, requires_grad=False, D=64, T=100):
    """What the dispatch reads of a tensor, on a CUDA device that this
    machine need not have."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                 requires_grad=requires_grad,
                                 shape=(2, 4, T, D))


def test_dispatch_reads_device_dtype_head_dim_precision_and_grad():
    def active(q, bias=None):
        return at.attention_active(q, q, q, bias)

    bias = (torch.zeros(32, 4), None)
    with highest_f32_precision():
        assert active(_fake_cuda()) and active(_fake_cuda(D=128), bias)
        assert not active(torch.zeros(2, 4, 10, 64))
        assert not active(_fake_cuda(torch.float64))
        assert not active(_fake_cuda(D=32))
        assert not active(_fake_cuda(requires_grad=True))
        with torch.no_grad():
            assert active(_fake_cuda(requires_grad=True))
        assert active(_fake_cuda(T=at.MAX_BIAS_T), bias)
        assert not active(_fake_cuda(T=at.MAX_BIAS_T + 1), bias)
        assert active(_fake_cuda(T=at.MAX_BIAS_T + 1))
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            assert not active(_fake_cuda())
        finally:
            use_highest_f32_precision()


def test_kernel_wrapper_refuses_the_cpu_and_misfits():
    q, k, v, _ = _inputs("esm2", 2, 10, seed=5)
    valid = torch.tensor([10, 3])
    with pytest.raises(ValueError, match="device cpu"):
        at.attention(q, k, v, valid)
    with pytest.raises(ValueError, match="heads of 32"):
        at.attention(q[..., :32], k[..., :32], v[..., :32], valid)
    with pytest.raises(ValueError, match="do not fit"):
        at.attention(q, k[:, :, :9], v, valid)
    with pytest.raises(ValueError, match="do not fit"):
        at.attention(q, k, v, valid[:1])


@pytest.mark.parametrize("valid,T,want", [
    ([1], 130, 64 * 64), ([64], 130, 64 * 64), ([65], 130, 128 * 128),
    ([130, 2], 130, 192 * 192 + 64 * 64), ([272, 0], 514, 320 * 320)])
def test_tile_pairs(valid, T, want):
    assert at.tile_pairs(valid, T) == want


def _sdpa_spans(run):
    profiling.reset()
    profiling.set_recording(True)
    try:
        with torch.no_grad():
            run()
        return profiling.spans()
    finally:
        profiling.set_recording(None)
        profiling.reset()


@pytest.mark.parametrize("route", ["twin", "kernel"])
def test_esm2_sdpa_spans_count_split_and_pairs(monkeypatch, route):
    """One ``model/esm/sdpa`` span a layer inside ``model/esm/attn``,
    counting ``split`` and ``pairs``: B·T² under the twin; under the kernel
    (here a stand-in that runs the twin) the tile-rounded pairs of the
    rows' L + 2 valid tokens, with one launch a layer."""
    cfg = esm2.ESM2Config(layers=2, dim=32, heads=4, ffn=64)
    params = esm2.init_esm2(cfg, torch.Generator().manual_seed(2), "cpu")
    tokens = torch.randint(0, 20, (3, 100),
                           generator=torch.Generator().manual_seed(3))
    lengths = torch.tensor([100, 61, 0])
    calls = []
    if route == "kernel":
        monkeypatch.setattr(at, "attention_active", lambda *a: True)
        monkeypatch.setattr(at, "attention",
                            lambda *a: calls.append(1) or at.attention_ref(*a))
    got = _sdpa_spans(lambda: esm2.esm2_forward(params, cfg, tokens, lengths))
    sdpa = [s for s in got if s.name == "model/esm/sdpa"]
    attn = {s.id for s in got if s.name == "model/esm/attn"}
    assert len(sdpa) == cfg.layers and {s.parent for s in sdpa} == attn
    split = int(route == "kernel")
    pairs = (128 * 128 + 64 * 64 + 64 * 64) if split else 3 * 102 * 102
    assert all(s.counts == {"split": split, "pairs": pairs} for s in sdpa)
    assert len(calls) == cfg.layers * split


def test_prott5_sdpa_spans_count_split_and_pairs():
    """ProtT5's ``model/t5/sdpa`` spans count the same; ``model/t5/bias``
    holds the tables once a batch."""
    cfg = prott5.ProtT5Config(layers=2, dim=64, heads=4, d_kv=32, ffn=128)
    params = prott5.init_prott5(cfg, torch.Generator().manual_seed(2), "cpu")
    tokens = torch.randint(0, 20, (2, 70),
                           generator=torch.Generator().manual_seed(3))
    got = _sdpa_spans(lambda: prott5.prott5_forward(params, cfg, tokens,
                                                    torch.tensor([70, 5])))
    sdpa = [s for s in got if s.name == "model/t5/sdpa"]
    assert len(sdpa) == cfg.layers
    assert all(s.counts == {"split": 0, "pairs": 2 * 71 * 71} for s in sdpa)
    assert len([s for s in got if s.name == "model/t5/bias"]) == 1


def test_package_calls_no_library_attention():
    """Every trunk's attention is E2 or its twin: the port's package (its
    Python and its CUDA sources) names PyTorch's fused attention nowhere."""
    root = Path(at.__file__).resolve().parent.parent
    hits = [str(p) for p in root.rglob("*")
            if p.suffix in (".py", ".cu", ".cuh")
            and "scaled_dot_product_attention" in p.read_text()]
    assert hits == []
