"""The plain reference agrees with the port at a small size on the CPU,
imports nothing of the port or of JAX, and rounds to TF32 as stated."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO, tiny_config
from portbench import reference, traffic, weights


def _proteins(n, seed=3):
    rng = np.random.default_rng(seed)
    return [traffic.aligned_protein(rng, int(rng.integers(20, 120)), 0.08)
            for _ in range(n)]


def _port_gcn(trees, config, proteins):
    from metagenomic_deepfri_tpu_torch.batching.engine import \
        _pad_batch_coords
    from metagenomic_deepfri_tpu_torch.models.deepfri import (
        GCNConfig, gcn_forward)
    from metagenomic_deepfri_tpu_torch.ops.cmap_align import \
        aligned_contacts_from_coords

    items = [(f"p{i}", *p) for i, p in enumerate(proteins)]
    L = max(len(p[0]) for p in proteins)
    tokens, lengths, coords, ins = (torch.from_numpy(a) for a in
                                    _pad_batch_coords(items, L, len(items)))
    adj = aligned_contacts_from_coords(coords, ins, lengths,
                                       config["contact_threshold"],
                                       config["generated_contacts"])
    out = {}
    for m, terms in config["modes"].items():
        cfg = GCNConfig(n_labels=terms, lm_hidden=config["lm_hidden"],
                        embed_dim=config["embed_dim"],
                        gc_dims=tuple(config["gc_dims"]),
                        fc_dims=tuple(config["fc_dims"]))
        out[m] = gcn_forward(trees[m], cfg, tokens, adj, lengths)
    return out


@pytest.mark.parametrize("name", ["deepfri_gcn_mf", "deepfri_set3"])
def test_gcn_reference_matches_the_port(name):
    config = tiny_config(name)
    trees = weights.make(config, 5, "cpu")["gcn"]
    proteins = _proteins(6)
    ref = reference.gcn_block(trees, config, proteins, "cpu")
    port = _port_gcn(trees, config, proteins)
    for m in config["modes"]:
        assert torch.allclose(ref[m], port[m], atol=2e-6, rtol=0), m
    tf = reference.gcn_block(trees, config, proteins, "cpu", reference.tf32)
    assert max((tf[m] - ref[m]).abs().max().item()
               for m in config["modes"]) > 1e-5


def test_cnn_reference_matches_the_port():
    from metagenomic_deepfri_tpu_torch.batching.engine import _pad_batch
    from metagenomic_deepfri_tpu_torch.models.deepfri import (CNNConfig,
                                                              cnn_forward)

    config = tiny_config("deepfri_set3",
                         cnn={"conv_filters": 8, "conv_kernels": [8, 16],
                              "fc_dims": [16]})
    trees = weights.make(config, 9, "cpu", nets=("cnn",))["cnn"]
    proteins = _proteins(5)
    ref = reference.cnn_block(trees, proteins, "cpu")
    L = max(len(p[0]) for p in proteins)
    tokens, lengths = (torch.from_numpy(a) for a in _pad_batch(
        [(f"p{i}", p[0]) for i, p in enumerate(proteins)], L, len(proteins)))
    for m, terms in config["modes"].items():
        cfg = CNNConfig(n_labels=terms, conv_filters=8, conv_kernels=(8, 16),
                        fc_dims=(16,))
        got = cnn_forward(trees[m], cfg, tokens, lengths)
        assert torch.allclose(ref[m], got, atol=2e-6, rtol=0), m


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference, portbench.flops, "
            "portbench.traffic, portbench.weights; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)],
                         capture_output=True, text=True, check=True).stdout
    tops = set(out.split())
    assert not tops & {"jax", "jaxlib", "flax", "metagenomic_deepfri_tpu",
                       "metagenomic_deepfri_tpu_torch"}


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -1.5,
                      1 + 2 ** -10, 3.0e38, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1 + 2 ** -9, -1.5, 1 + 2 ** -10,
                         float(reference.tf32(torch.tensor([3.0e38]))[0]),
                         0.0])
    got = reference.tf32(x)
    assert torch.equal(got, want)
    bits = got.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0


def test_adjacency_by_hand():
    coords = np.array([[0, 0, 0], [3, 0, 0], [6.5, 0, 0], [1e6 + 3e3, 0, 0]],
                      np.float32)
    ins = np.array([False, False, False, True])
    adj = reference.adjacency([("ACDE", coords, ins)], 5, 6.0, 2, "cpu")[0]
    want = torch.tensor([[1, 1, 0, 0, 0],
                         [1, 1, 1, 1, 0],
                         [0, 1, 1, 1, 0],
                         [0, 1, 1, 1, 0],
                         [0, 0, 0, 0, 0]], dtype=torch.float32)
    assert torch.equal(adj, want)
