"""GraphConv CUDA kernels against their plain PyTorch twins, on the GPU.

Marked ``cuda``: they skip where no CUDA device is present. On a machine
with one (and without JAX, which this file does not import), run them as

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

``--noconftest`` keeps ``tests/conftest.py``, which configures JAX, out.
"""

import numpy as np
import pytest
import torch

from metagenomic_deepfri_tpu_torch.models.deepfri import (GCNConfig,
                                                          gcn_forward,
                                                          gcn_forward_fused,
                                                          init_gcn)
from metagenomic_deepfri_tpu_torch.ops import graphconv as gc
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
