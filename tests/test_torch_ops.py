"""Port ops (torch, CPU) against the JAX package on identical numpy inputs.

JAX functions that reach a Pallas kernel run with ``interpret=True``, as
``tests/test_pallas.py`` runs them. On CPU tensors the port's GraphConv
wrappers run their plain twins; the CUDA kernels themselves are tested on
the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metagenomic_deepfri_tpu.ops import cmap_align as jax_cmap
from metagenomic_deepfri_tpu.ops import graphconv_pallas as jax_gc
from metagenomic_deepfri_tpu.ops import one_hot as jax_one_hot
from metagenomic_deepfri_tpu_torch.ops import cmap_align, one_hot
from metagenomic_deepfri_tpu_torch.ops import graphconv as gc
from metagenomic_deepfri_tpu_torch.synthetic import (aligned_protein,
                                                     contact_batch,
                                                     near_threshold_batch)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def test_vocabulary_and_tokens_match():
    assert one_hot.ALPHABET == jax_one_hot.ALPHABET
    assert one_hot.VOCAB_SIZE == jax_one_hot.VOCAB_SIZE
    assert one_hot.PAD_TOKEN == jax_one_hot.PAD_TOKEN
    seq = "MKTAYIAKQRQISFVKSHFSRQXBZUO-"
    np.testing.assert_array_equal(one_hot.seq2tokens(seq),
                                  jax_one_hot.seq2tokens(seq))
    with pytest.raises(ValueError):
        one_hot.seq2tokens("MK1")


def test_tokens2onehot_exact():
    tokens = np.random.default_rng(0).integers(
        0, one_hot.VOCAB_SIZE, (3, 17)).astype(np.uint8)
    ref = np.asarray(jax_one_hot.tokens2onehot(jnp.asarray(tokens)))
    out = one_hot.tokens2onehot(torch.from_numpy(tokens)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_project_alignment_coords_matches_jax():
    rng = np.random.default_rng(3)
    target = rng.normal(size=(40, 3)).astype(np.float32) * 5
    q_aln, t_aln = "AA-AAAA--AAAAAAAA-AAAA", "AAAA-AAAAAA-AAAAAAAAAA"
    got = cmap_align.project_alignment_coords(q_aln, t_aln, target)
    ref = jax_cmap.project_alignment_coords(q_aln, t_aln, target)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(g, r)
    assert got[2] == ref[2]
    with pytest.raises(IndexError):
        cmap_align.project_alignment_coords("AAAA", "AAAA", target[:2])


@pytest.mark.parametrize("case", ["L128", "L130", "near_threshold",
                                  "aligned"])
def test_aligned_contacts_exact(case):
    if case == "near_threshold":
        batch = near_threshold_batch(B=2, L=96, seed=4)
    elif case == "aligned":
        rng = np.random.default_rng(5)
        _, proj, ins = aligned_protein(rng, 90)
        coords = np.zeros((1, 96, 3), np.float32)
        coords[0, :90] = proj
        mask = np.zeros((1, 96), bool)
        mask[0, :90] = ins
        batch = (coords, mask, np.array([90], np.int32))
    else:
        batch = contact_batch(B=2, L=int(case[1:]), seed=int(case[1:]))
    ref = np.asarray(jax_cmap.aligned_contacts_from_coords(*_jax(*batch)))
    out = cmap_align.aligned_contacts_from_coords(*_torch(*batch)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("L", [128, 130])
def test_contact_degrees_matches_pallas(L):
    batch = contact_batch(B=2, L=L, seed=L + 1)
    ref = np.asarray(jax_gc.contact_degrees(*_jax(*batch), interpret=True))
    out = gc.contact_degrees(*_torch(*batch)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("D", [48, 128])
@pytest.mark.parametrize("L", [96, 130, 256])
def test_graphconv_aggregate_matches_pallas(L, D):
    batch = contact_batch(B=2, L=L, seed=L + D)
    xs = np.random.default_rng(D).normal(size=(2, L, D)).astype(np.float32)
    ref = np.asarray(jax_gc.graphconv_aggregate(
        *_jax(*batch), jnp.asarray(xs), interpret=True))
    out = gc.graphconv_aggregate(*_torch(*batch), torch.from_numpy(xs))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_graphconv_aggregate_bf16_matches_pallas():
    batch = contact_batch(B=2, L=130, seed=9)
    xs = np.random.default_rng(9).normal(size=(2, 130, 48)).astype(np.float32)
    ref = np.asarray(jax_gc.graphconv_aggregate(
        *_jax(*batch), jnp.asarray(xs), interpret=True,
        compute_dtype="bfloat16"))
    out = gc.graphconv_aggregate(*_torch(*batch), torch.from_numpy(xs),
                                 compute_dtype="bfloat16")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("adj_norm", ["sym", "row", "none"])
def test_normalized_aggregate_matches_pallas(adj_norm):
    batch = contact_batch(B=2, L=96, seed=11)
    x = np.random.default_rng(11).normal(size=(2, 96, 48)).astype(np.float32)
    ref, ref_deg = jax_gc.normalized_aggregate(
        *_jax(*batch), jnp.asarray(x), adj_norm=adj_norm, interpret=True)
    out, deg = gc.normalized_aggregate(*_torch(*batch), torch.from_numpy(x),
                                       adj_norm=adj_norm)
    np.testing.assert_allclose(deg.numpy(), np.asarray(ref_deg), rtol=0,
                               atol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


def test_cpu_route_launches_no_kernel():
    gc.reset_launch_counts()
    batch = _torch(*contact_batch(B=2, L=64, seed=1))
    deg = gc.contact_degrees(*batch)
    gc.graphconv_aggregate(*batch, torch.ones((2, 64, 8)))
    gc.normalized_aggregate(*batch, torch.ones((2, 64, 8)), degrees=deg)
    assert gc.contact_degrees.launches == 0
    assert gc.graphconv_aggregate.launches == 0


def test_wrappers_reject_other_devices_and_dtypes():
    coords = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="no GraphConv kernel"):
        gc.contact_degrees(coords, torch.zeros((1, 4), dtype=torch.bool,
                                               device="meta"),
                           torch.zeros(1, dtype=torch.int32, device="meta"))
    batch = _torch(*contact_batch(B=1, L=8, seed=0))
    with pytest.raises(ValueError, match="compute_dtype"):
        gc.graphconv_aggregate(*batch, torch.ones((1, 8, 4)),
                               compute_dtype="float16")
    with pytest.raises(ValueError, match="normalisation"):
        gc.normalized_aggregate(*batch, torch.ones((1, 8, 4)),
                                adj_norm="bogus")
