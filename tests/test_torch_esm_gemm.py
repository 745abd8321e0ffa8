"""The split GEMM of ESM-2's, ProtT5's and ESM C's projections
(``ops/esm_gemm.py``) on the CPU: its plain twin against float64 (with a
bias or none, every epilogue, ESM C's gated one among them), the weight
planes' split and cache, the dispatch that keeps ``torch.addmm``
(``torch.mm`` without a bias) off the card, the ``model/esm/gemm`` spans,
and the benchmark's reader of them. The kernel itself is held on the card
by ``tests/test_torch_cuda.py``, and its gated instance here too (marked
``cuda``, skipped without a card)."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from metagenomic_deepfri_tpu_torch import profiling
from metagenomic_deepfri_tpu_torch.models import esm2
from metagenomic_deepfri_tpu_torch.ops import esm_gemm as eg
from metagenomic_deepfri_tpu_torch.ops.attention import attention_ref
from metagenomic_deepfri_tpu_torch.precision import (highest_f32_precision,
                                                     use_highest_f32_precision)
from portbench.readers import esm2_gemm_roofline

TINY = esm2.ESM2Config(layers=2, dim=32, heads=4, ffn=64)
# (K, N) of the trunk's projections at a tiny width: qkv, out, fc1, fc2.
SHAPES = [(32, 96), (32, 32), (32, 128), (128, 32), (40, 24), (13, 7)]


def _data(M, K, N, seed, extremes=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, N).astype(np.float32)
    if extremes:
        # Rows of x and columns of w scaled far from 1, one sign each, so
        # the planes of every magnitude meet in the products.
        x *= (10.0 ** rng.uniform(-30, 30, (M, 1))).astype(np.float32)
        w *= (10.0 ** rng.uniform(-5, 5, (1, N))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)


def _relative_error(y, x, w, b, residual=None):
    """max |y − y₆₄| / (|x|·|w| + |b| (+ |residual|)), all in float64 (b
    None: no bias)."""
    x64, w64 = x.double(), w.double()
    b64 = torch.zeros(w.shape[1], dtype=torch.float64) if b is None \
        else b.double()
    ref = x64 @ w64 + b64
    scale = x64.abs() @ w64.abs() + b64.abs()
    if residual is not None:
        ref = residual.double() + ref
        scale = scale + residual.double().abs()
    return float(((y.double() - ref).abs() / scale).max())


@pytest.mark.parametrize("extremes", [False, True], ids=["normal", "extreme"])
@pytest.mark.parametrize("K,N", SHAPES)
def test_twin_within_float32_rounding_of_float64(K, N, extremes):
    """Three planes, six products, float32 sums: within a few float32 ulps
    of |x|·|w| of float64, as a float32 matmul is."""
    x, w, b = _data(77, K, N, seed=K * N, extremes=extremes)
    y = eg.esm_gemm_ref(x, eg.split_planes(w), b)
    plain = torch.addmm(b, x, w)
    u = 2.0 ** -24
    assert _relative_error(y, x, w, b) <= 4 * K * u
    assert _relative_error(plain, x, w, b) <= 4 * K * u


@pytest.mark.parametrize("epilogue", ["gelu", "residual", "relu"])
def test_twin_epilogues(epilogue):
    x, w, b = _data(50, 32, 64, seed=3)
    res = torch.randn(50, 64, generator=torch.Generator().manual_seed(4))
    planes = eg.split_planes(w)
    y = eg.esm_gemm_ref(x, planes, b, epilogue,
                        res if epilogue == "residual" else None)
    base = eg.esm_gemm_ref(x, planes, b)
    want = {"gelu": F.gelu(base), "relu": torch.relu(base),
            "residual": res + base}[epilogue]
    assert torch.equal(y, want)
    assert bool((base < 0).any())


# (K, N) of ProtT5's projections at a reduced width (qkv, o, wi, wo), and
# wo's reduction at its published 16,384.
T5_SHAPES = [(64, 384), (128, 64), (64, 256), (256, 64), (16384, 40)]


@pytest.mark.parametrize("epilogue", ["bias", "relu", "residual"])
@pytest.mark.parametrize("K,N", T5_SHAPES)
def test_twin_without_bias_against_float64(K, N, epilogue):
    """No bias (ProtT5's projections): the twin's product within a few
    float32 ulps of |x|·|w| (+ |residual|) of float64, as ``torch.mm`` is;
    ReLU and the residual add after it as PyTorch computes them."""
    x, w, _ = _data(37, K, N, seed=K + N)
    res = (torch.randn(37, N, generator=torch.Generator().manual_seed(6))
           if epilogue == "residual" else None)
    planes = eg.split_planes(w)
    y = eg.esm_gemm_ref(x, planes, None, epilogue, res)
    base = eg.esm_gemm_ref(x, planes, None)
    u = 2.0 ** -24
    if epilogue == "relu":
        assert torch.equal(y, torch.relu(base))
        y = base
    assert _relative_error(y, x, w, None, res) <= 4 * K * u
    plain = torch.mm(x, w) if res is None else res + torch.mm(x, w)
    assert _relative_error(plain, x, w, None, res) <= 4 * K * u


def test_project_on_the_cpu_is_plain_pytorch():
    """Off the card :func:`project` is ``torch.mm`` (no bias) or
    ``torch.addmm``, then PyTorch's epilogue, bit for bit, under its span
    with ``split`` 0 and no launch."""
    x, w, b = _data(6, 16, 24, seed=8)
    res = torch.randn(6, 24, generator=torch.Generator().manual_seed(9))
    launches = eg.esm_gemm.launches
    for p, plain in (({"kernel": w}, torch.mm(x, w)),
                     ({"kernel": w, "bias": b}, torch.addmm(b, x, w))):
        for epilogue, want in (("bias", plain), ("relu", torch.relu(plain)),
                               ("gelu", F.gelu(plain)),
                               ("residual", res + plain)):
            got = eg.project(p, x[None], torch.float32, "test/gemm",
                             epilogue,
                             res[None] if epilogue == "residual" else None)
            assert got.shape == (1, 6, 24)
            assert torch.equal(got[0], want)
    assert eg.esm_gemm.launches == launches


def test_planes_split_exactly():
    """hi + mid + lo == w bit for bit, in bf16, K-major, zero past K."""
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(13, 9))
         * 10.0 ** rng.uniform(-30, 30, (13, 9))).astype(np.float32)
    f32_max = float(torch.finfo(torch.float32).max)
    w[0, :4] = (f32_max, -f32_max, 3.3962e38, 2.0 ** -103)
    w = torch.from_numpy(w)
    planes = eg.split_planes(w)
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, 9, 16)
    assert not bool(planes[:, :, 13:].any())
    total = planes[:, :, :13].to(torch.float64).sum(0)
    assert torch.equal(total, w.t().to(torch.float64))
    assert bool(torch.isfinite(planes[0].float() + planes[1].float()).all())


def test_weight_planes_cached_by_identity_and_version():
    w = torch.randn(16, 8)
    first = eg.weight_planes(w)
    assert eg.weight_planes(w) is first
    assert eg.weight_planes(w.clone()) is not first
    w.mul_(2.0)
    again = eg.weight_planes(w)
    assert again is not first
    assert torch.equal(again.to(torch.float64).sum(0),
                       w.t().to(torch.float64))
    key = (id(w), False)   # the planes' identity and layout (not gated)
    assert key in eg._planes
    del w
    assert key not in eg._planes


def test_weight_planes_of_an_inference_tensor():
    """A kernel made under ``torch.inference_mode`` (it has no version
    counter) is split once and kept, as any other."""
    with torch.inference_mode():
        w = torch.randn(16, 8)
    first = eg.weight_planes(w)
    assert eg.weight_planes(w) is first
    assert torch.equal(first.to(torch.float64).sum(0),
                       w.t().to(torch.float64))
    with torch.inference_mode():
        assert eg.weight_planes(w) is first


def test_rejects_what_it_does_not_take():
    x, w, b = _data(4, 8, 8, seed=0)
    with pytest.raises(ValueError):
        eg.esm_gemm(x, w, b, "tanh")
    with pytest.raises(ValueError):
        eg.esm_gemm(x, w, b[:4])
    with pytest.raises(ValueError):
        eg.esm_gemm(x, w, b, "residual")
    with pytest.raises(ValueError):
        eg.esm_gemm(x, w, b, "bias", torch.zeros(4, 8))
    with pytest.raises(ValueError):
        eg.esm_gemm(x, w[:4], b)
    with pytest.raises(ValueError):  # no K to sum over
        eg.esm_gemm(x[:, :0], w[:0], b)
    with pytest.raises(ValueError):  # the kernel runs on CUDA tensors only
        eg.esm_gemm(x, w, b)


def _fake_cuda(dtype=torch.float32, requires_grad=False):
    """What the dispatch reads of a tensor, on a CUDA device that this
    machine need not have."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                 requires_grad=requires_grad)


def test_dispatch_reads_device_dtype_precision_and_grad():
    w = torch.zeros(2, 2)
    with highest_f32_precision():
        assert eg.split_gemm_active(_fake_cuda(), w)
        assert not eg.split_gemm_active(torch.zeros(2, 2), w)
        assert not eg.split_gemm_active(_fake_cuda(torch.float64), w)
        assert not eg.split_gemm_active(_fake_cuda(), w.double())
        assert not eg.split_gemm_active(_fake_cuda(requires_grad=True), w)
        with torch.no_grad():
            assert eg.split_gemm_active(_fake_cuda(requires_grad=True), w)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            assert not eg.split_gemm_active(_fake_cuda(), w)
        finally:
            use_highest_f32_precision()
        torch.set_float32_matmul_precision("high")
        try:
            assert not eg.split_gemm_active(_fake_cuda(), w)
        finally:
            use_highest_f32_precision()


def _trunk_as_before(params, config, tokens, lengths, dtype):
    """The trunk as it was written with ``torch.addmm``, ``F.gelu`` and
    the residual adds outside the projections (the attention is E2's
    twin, as the port runs it off the card)."""
    def linear(p, x):
        return torch.addmm(p["bias"].to(dtype), x.reshape(-1, x.shape[-1]),
                           p["kernel"].to(dtype)).view(*x.shape[:-1], -1)

    ids = esm2.esm_tokens(tokens, lengths)
    B, T = ids.shape
    H, hd = config.heads, config.head_dim
    n = lengths.to(torch.int64) + 2
    valid = torch.arange(T)[None, :] < n[:, None]
    x = params["embed"].to(dtype)[ids] * esm2.TOKEN_DROPOUT_SCALE
    x = x * valid[:, :, None].to(dtype)
    cos, sin = esm2._rotary(T, hd, config.rope_base, ids.device, dtype)
    for p in params["layers"]:
        h = esm2._norm(p["ln1"], x, config.ln_eps, dtype)
        q, k, v = linear(p["qkv"], h).view(B, T, 3, H, hd).permute(
            2, 0, 3, 1, 4)
        q = esm2._rotate(q * hd ** -0.5, cos, sin)
        k = esm2._rotate(k, cos, sin)
        a = attention_ref(q, k, v, n)
        x = x + linear(p["out"], a)
        h = esm2._norm(p["ln2"], x, config.ln_eps, dtype)
        x = x + linear(p["fc2"], F.gelu(linear(p["fc1"], h)))
    x = esm2._norm(params["ln_after"], x, config.ln_eps, dtype)
    return x[:, 1:T - 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_trunk_keeps_addmm_bit_for_bit(dtype):
    """Off the card (and in float64) the projections are ``torch.addmm``
    with PyTorch's GELU and adds, as before the split kernel: the same
    bits, and no launch."""
    params = esm2.init_esm2(TINY, torch.Generator().manual_seed(2), "cpu")
    tokens = torch.randint(0, 20, (3, 24),
                           generator=torch.Generator().manual_seed(3))
    lengths = torch.tensor([24, 5, 0])
    launches = eg.esm_gemm.launches
    got = esm2.esm2_forward(params, TINY, tokens, lengths, dtype)
    want = _trunk_as_before(params, TINY, tokens, lengths, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert eg.esm_gemm.launches == launches


def test_gemm_spans_four_a_layer_parented_and_counted():
    """Each layer's qkv and out projections run under ``model/esm/gemm``
    spans inside ``model/esm/attn``, fc1 and fc2 inside ``model/esm/ffn``;
    each counts ``rows`` (B·T), ``k``, ``n`` and ``split`` (0 on the
    CPU)."""
    params = esm2.init_esm2(TINY, torch.Generator().manual_seed(2), "cpu")
    tokens = torch.randint(0, 20, (2, 10),
                           generator=torch.Generator().manual_seed(3))
    profiling.reset()
    profiling.set_recording(True)
    try:
        esm2.esm2_forward(params, TINY, tokens, torch.tensor([10, 4]))
        got = profiling.spans()
    finally:
        profiling.set_recording(None)
        profiling.reset()
    by_id = {s.id: s for s in got}
    gemm = [s for s in got if s.name == "model/esm/gemm"]
    assert len(gemm) == 4 * TINY.layers
    d, f, rows = TINY.dim, TINY.ffn, 2 * 12
    want = [("model/esm/attn", d, 3 * d), ("model/esm/attn", d, d),
            ("model/esm/ffn", d, f), ("model/esm/ffn", f, d)] * TINY.layers
    for s, (parent, k, n) in zip(gemm, want):
        assert by_id[s.parent].name == parent
        assert s.counts == {"rows": rows, "k": k, "n": n, "split": 0}
        assert s.device_s is not None and s.device_s >= 0


def _record(n_batches, layers, gemm_per_batch, device_s=1e-3):
    span = types.SimpleNamespace
    spans = []
    for _ in range(n_batches):
        spans.append(span(name="model/lm", counts={"tokens": 10},
                          device_s=1.0))
        spans += [span(name="model/esm/gemm", device_s=device_s,
                       counts={"rows": 1000, "k": 64, "n": 32, "split": 1})
                  for _ in range(gemm_per_batch)]
    return spans, {"device_kind": "NVIDIA H100 80GB HBM3",
                   "config": {"esm": {"layers": layers}}}


@pytest.mark.parametrize("per_batch,reads", [(8, True), (7, False),
                                             (0, False)])
def test_gemm_roofline_reader(monkeypatch, per_batch, reads):
    """Σ 2·rows·k·n at 989 TFLOP/s over Σ device seconds of the spans, and
    nothing unless they number four a layer and a batch."""
    spans, record = _record(3, 2, per_batch)
    monkeypatch.setattr(esm2_gemm_roofline.spans, "windowed",
                        lambda rec: spans)
    got = esm2_gemm_roofline.read(record, {"span": "model/esm/gemm"})
    if not reads:
        assert got is None
        return
    want = 100.0 * (2.0 * 1000 * 64 * 32 / 989e12) / 1e-3
    assert got == pytest.approx(want)


# -- the gated epilogue of ESM C's fc1 ------------------------------------------

def _swiglu_scale(x64, w64):
    """(silu(a)·b of float64, its condition scale |silu'(a)|·|b|·(|x|·|W_a|)
    + |silu(a)|·(|x|·|W_b|)): the error of ``silu(a)·b`` from a and b each
    within float32 rounding of |x|·|W|."""
    a, b = (x64 @ w64).chunk(2, dim=-1)
    sa, sb = (x64.abs() @ w64.abs()).chunk(2, dim=-1)
    sig = torch.sigmoid(a)
    slope = (sig * (1 + a * (1 - sig))).abs()
    return F.silu(a) * b, slope * b.abs() * sa + F.silu(a).abs() * sb


@pytest.mark.parametrize("K,F_", [(128, 512), (96, 100), (3072, 64)])
def test_twin_swiglu_against_float64(K, F_):
    """``silu(a) ⊙ b`` of the twin's product halves ``[a | b]``: within a
    few float32 ulps of float64's, over its condition scale, as
    ``F.silu(a) * b`` of ``torch.mm`` is."""
    x, w, _ = _data(41, K, 2 * F_, seed=K + F_)
    y = eg.esm_gemm_ref(x, eg.split_planes(w), None, "swiglu")
    plain = torch.mm(x, w)
    plain = F.silu(plain[:, :F_]) * plain[:, F_:]
    want, scale = _swiglu_scale(x.double(), w.double())
    scale = scale + want.abs()
    u = 2.0 ** -24
    for got in (y, plain):
        assert got.shape == (41, F_)
        assert float(((got.double() - want).abs() / scale).max()) <= 4 * K * u


def test_project_swiglu_on_the_cpu_is_plain_pytorch():
    """Off the card the gated projection is ``torch.mm``, then
    ``F.silu(a) * b`` of its halves, bit for bit, with the counter ``n``
    the 2F columns the product computes, and no launch."""
    x, w, _ = _data(6, 16, 48, seed=10)
    launches = eg.esm_gemm.launches
    profiling.reset()
    profiling.set_recording(True)
    try:
        got = eg.project({"kernel": w}, x[None], torch.float32, "test/gemm",
                         "swiglu")
        spans = profiling.spans()
    finally:
        profiling.set_recording(None)
        profiling.reset()
    plain = torch.mm(x, w)
    assert got.shape == (1, 6, 24)
    assert torch.equal(got[0], F.silu(plain[:, :24]) * plain[:, 24:])
    assert [s.counts for s in spans] == [{"rows": 6, "k": 16, "n": 48,
                                          "split": 0}]
    assert eg.esm_gemm.launches == launches


def test_swiglu_rejects_a_bias_and_an_odd_width():
    x, w, b = _data(4, 8, 8, seed=0)
    with pytest.raises(ValueError, match="swiglu"):
        eg.esm_gemm(x, w, b, "swiglu")
    with pytest.raises(ValueError, match="swiglu"):
        eg.esm_gemm(x, w[:, :7], None, "swiglu")
    with pytest.raises(ValueError, match="even"):
        eg.interleave_swiglu(w[:, :7])


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,F_", [(33280 - 37, 1152, 3072), (300, 96, 100),
                                    (129, 3072, 64)])
def test_swiglu_kernel_against_twin_on_card(M, K, F_):
    """E1's gated instance on the card (ESM C's fc1 at a ragged batch, and
    widths that leave a tile's gates part empty): within 2⁻²³ of its twin
    on the un-interleaved kernel, normwise over the condition scale (the
    bound of ``chip_smoke.GEMM_TWIN_RMS``), and finite; one launch, F
    columns written. A twin without its lo planes (what a kernel that lost
    them would give) must miss that bound at each of these shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(M + K + F_)
    x = torch.randn(M, K, generator=gen, device=dev)
    w = (torch.rand(K, 2 * F_, generator=gen, device=dev) * 2 - 1) * (
        6.0 / (K + 2 * F_)) ** 0.5
    use_highest_f32_precision()
    launches = eg.esm_gemm.launches
    got = eg.esm_gemm(x, w, None, "swiglu")
    assert eg.esm_gemm.launches == launches + 1
    planes = eg.split_planes(w)
    twin = eg.esm_gemm_ref(x, planes, None, "swiglu")
    hi, mid, _ = eg._split_bf16x3(x)
    cut_planes = planes.clone()
    cut_planes[2].zero_()
    cut = eg.esm_gemm_ref(hi.float() + mid.float(), cut_planes, None,
                          "swiglu")
    _, scale = _swiglu_scale(x.double(), w.double())
    norm = scale.norm()
    gap = float((got.double() - twin.double()).norm() / norm)
    cut_gap = float((cut.double() - twin.double()).norm() / norm)
    print(f"swiglu M={M} K={K} F={F_}: to twin normwise {gap:.3g}, "
          f"without lo planes {cut_gap:.3g}")
    assert got.shape == (M, F_) and torch.isfinite(got).all()
    assert gap <= 2.0 ** -23 < cut_gap
