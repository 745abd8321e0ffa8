"""CUDA kernels against their plain PyTorch twins, on the GPU.

B1/B2 (``csrc/graphconv.cu``) and B3 (``csrc/contact.cu``), plus one
full-width fine-tuning step whose float32 loss and gradients are held to
float64 on the card.

Marked ``cuda``: they skip where no CUDA device is present. On a machine
with one (and without JAX, which this file does not import), run them as

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

``--noconftest`` keeps ``tests/conftest.py``, which configures JAX, out.
"""

import dataclasses

import numpy as np
import pytest
import torch

from metagenomic_deepfri_tpu_torch.models.convert import gcn_params_from_numpy
from metagenomic_deepfri_tpu_torch.models.deepfri import (GCNConfig,
                                                          gcn_forward,
                                                          gcn_forward_fused,
                                                          init_gcn)
from metagenomic_deepfri_tpu_torch.ops import contact
from metagenomic_deepfri_tpu_torch.ops import graphconv as gc
from metagenomic_deepfri_tpu_torch.parallel import train
from metagenomic_deepfri_tpu_torch.precision import use_highest_f32_precision
from metagenomic_deepfri_tpu_torch.ops.cmap_align import \
    aligned_contacts_from_coords
from metagenomic_deepfri_tpu_torch.synthetic import (contact_batch,
                                                     near_threshold_batch)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(device, coords, ins, lengths):
    return (torch.from_numpy(coords).to(device),
            torch.from_numpy(ins).to(device),
            torch.from_numpy(lengths).to(device))


@pytest.mark.parametrize("L", [130, 512])
def test_degrees_exact(cuda, L):
    args = _on(cuda, *contact_batch(B=4, L=L, seed=L))
    before = gc.contact_degrees.launches
    deg = gc.contact_degrees(*args)
    ref = gc.contact_degrees_ref(*args)
    torch.cuda.synchronize()
    assert gc.contact_degrees.launches == before + 1
    torch.testing.assert_close(deg, ref, rtol=0, atol=0)


def test_degrees_near_threshold_exact(cuda):
    args = _on(cuda, *near_threshold_batch(B=4, L=512, seed=1))
    torch.testing.assert_close(gc.contact_degrees(*args),
                               gc.contact_degrees_ref(*args), rtol=0, atol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [48, 512, 1024])
@pytest.mark.parametrize("L", [130, 512])
def test_aggregate_matches_twin(cuda, L, D, compute_dtype):
    coords, ins, lengths = _on(cuda, *contact_batch(B=4, L=L, seed=D + L))
    g = torch.Generator().manual_seed(D)
    xs = torch.randn((4, L, D), generator=g).to(cuda)
    before = gc.graphconv_aggregate.launches
    out = gc.graphconv_aggregate(coords, ins, lengths, xs,
                                 compute_dtype=compute_dtype)
    ref = gc.graphconv_aggregate_ref(coords, ins, lengths, xs,
                                     compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert gc.graphconv_aggregate.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


def test_rejects_wrong_dtype(cuda):
    coords, ins, lengths = _on(cuda, *contact_batch(B=2, L=64, seed=0))
    with pytest.raises(TypeError):
        gc.contact_degrees(coords, ins, lengths.to(torch.int64))
    with pytest.raises(ValueError):
        gc.graphconv_aggregate(coords, ins, lengths,
                               torch.zeros((2, 64, 8), device=cuda)[:, ::2])


def test_fused_forward_matches_dense(cuda):
    cfg = GCNConfig(n_labels=8, lm_hidden=16, lm_layers=1, embed_dim=128,
                    gc_dims=(128, 128), fc_dims=(32,))
    params = init_gcn(cfg, torch.Generator().manual_seed(0), cuda)
    coords, ins, lengths = _on(cuda, *contact_batch(B=2, L=128, seed=3))
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(
        rng.integers(1, 20, (2, 128)).astype(np.uint8)).to(cuda)
    adj = aligned_contacts_from_coords(coords, ins, lengths)
    ref = gcn_forward(params, cfg, tokens, adj, lengths)
    out = gcn_forward_fused(params, cfg, tokens, coords, ins, lengths)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["L130", "L512", "near_threshold"])
def test_contact_map_exact(cuda, case):
    """B3 against its twin, exact: sentinel coordinates (1e6 + 1e3·i, far
    from everything), ragged lengths, and pairs at 6 Å ± 1 ulp."""
    if case == "near_threshold":
        coords, _, lengths = near_threshold_batch(B=4, L=512, seed=2)
        lengths[1:] = (500, 129, 1)
    else:
        coords, _, lengths = contact_batch(B=4, L=int(case[1:]),
                                           seed=int(case[1:]))
    coords = torch.from_numpy(coords).to(cuda)
    lengths = torch.from_numpy(lengths).to(cuda)
    before = contact.contact_map_fused.launches
    out = contact.contact_map_fused(coords, lengths)
    ref = contact.batched_contact_maps(coords, lengths)
    torch.cuda.synchronize()
    assert contact.contact_map_fused.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("B, L", [(0, 64), (3, 0), (2, 1), (1, 65)])
def test_contact_map_edge_shapes(cuda, B, L):
    coords = torch.randn((B, L, 3), device=cuda)
    lengths = torch.full((B,), L, dtype=torch.int32, device=cuda)
    out = contact.contact_map_fused(coords, lengths)
    assert out.shape == (B, L, L) and out.dtype == torch.float32
    torch.testing.assert_close(out, contact.batched_contact_maps(
        coords, lengths), rtol=0, atol=0)


def test_contact_map_rejects_bad_inputs(cuda):
    coords = torch.zeros((2, 8, 3), device=cuda)
    lengths = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        contact.contact_map_fused(coords.double(), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        contact.contact_map_fused(
            torch.zeros((2, 8, 6), device=cuda)[:, :, ::2], lengths)
    with pytest.raises(ValueError, match="is on"):
        contact.contact_map_fused(coords, lengths.cpu())


def test_full_width_step_matches_float64(cuda):
    """One step at the published width (mf head, 489 terms): float32 loss
    and every gradient leaf within normwise rtol 1e-4 of float64, both on
    the card (TF32 would exceed it)."""
    use_highest_f32_precision()
    cfg = GCNConfig(n_labels=489, adj_norm="none")
    params = init_gcn(cfg, torch.Generator().manual_seed(0), "cpu")
    coords, _, lengths = contact_batch(B=4, L=256, seed=5)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(
        rng.integers(1, 25, (4, 256)).astype(np.uint8)).to(cuda)
    labels = torch.from_numpy(
        (rng.random((4, 489)) < 0.01).astype(np.int32)).to(cuda)
    lengths = torch.from_numpy(lengths).to(cuda)
    adj = contact.contact_map_fused(torch.from_numpy(coords).to(cuda),
                                    lengths)
    out = {}
    for c in (cfg, dataclasses.replace(cfg, compute_dtype="float64")):
        dtype = torch.float64 if c.compute_dtype == "float64" \
            else torch.float32
        p = gcn_params_from_numpy(params, cuda, dtype, requires_grad=True)
        loss = train.gcn_loss(p, c, tokens, adj.to(dtype), lengths, labels)
        out[dtype] = [loss] + list(torch.autograd.grad(
            loss, train.param_leaves(p)))
    for g, r in zip(out[torch.float32], out[torch.float64], strict=True):
        err = (g.double() - r).abs().max() / r.abs().max().clamp_min(1e-300)
        assert err.item() <= 1e-4
