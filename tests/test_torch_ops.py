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
from metagenomic_deepfri_tpu.ops import contact as jax_contact
from metagenomic_deepfri_tpu.ops import graphconv_pallas as jax_gc
from metagenomic_deepfri_tpu.ops import one_hot as jax_one_hot
from metagenomic_deepfri_tpu_torch.ops import cmap_align, contact, one_hot
from metagenomic_deepfri_tpu_torch.ops import graphconv as gc
from metagenomic_deepfri_tpu_torch.synthetic import (aligned_protein,
                                                     contact_batch,
                                                     near_threshold_batch,
                                                     with_float32_extremes)


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


def test_split_bf16x3_exact():
    """hi + mid + lo == x in float64 across exponents 1e-30 to 1e30, both
    signs and zero; every plane is bfloat16, and a nonzero plane is a normal
    bf16 (>= 2**-126), so a tensor core that flushes subnormals loses
    nothing in this range."""
    rng = np.random.default_rng(21)
    mag = 10.0 ** rng.uniform(-30.0, 30.0, 50_000)
    x = np.concatenate([mag * rng.choice([-1.0, 1.0], mag.size),
                        [0.0, -0.0, 1e-30, -1e30, 2.0 ** -103]])
    x = torch.from_numpy(x.astype(np.float32))
    planes = gc._split_bf16x3(x)
    assert all(p.dtype == torch.bfloat16 for p in planes)
    total = sum(p.to(torch.float64) for p in planes)
    assert torch.equal(total, x.to(torch.float64))
    for p in planes:
        v = p.to(torch.float64).abs()
        assert bool(((v == 0) | (v >= 2.0 ** -126)).all())


def test_split_bf16x3_limits():
    """The stated limits: exact down to 2**-110 (lo then a bf16 subnormal),
    bits lost below it; exact up to float32's largest value, with hi at most
    bf16's largest finite value (rounded toward zero) and hi + mid finite in
    float32, as the kernel's accumulator adds them; infinities and NaN are
    carried by hi alone."""
    ulp = 1.0 + 2.0 ** -23
    f32_max = float(torch.finfo(torch.float32).max)
    big = [3.3895e38, 3.3962e38, 3.4e38, f32_max, -3.4e38, -f32_max]
    x = torch.tensor([2.0 ** -110 * ulp, 2.0 ** -111 * ulp, *big,
                      float("inf"), -float("inf"), float("nan")],
                     dtype=torch.float32)
    hi, mid, lo = gc._split_bf16x3(x)
    total = (hi.to(torch.float64) + mid.to(torch.float64)
             + lo.to(torch.float64))
    exact = (total == x.to(torch.float64)).tolist()
    n = 2 + len(big)
    assert exact[:n] == [True, False] + [True] * len(big)
    assert bool(torch.isfinite(hi[:n]).all())
    assert bool(torch.isfinite(hi[:n].float() + mid[:n].float()).all())
    bf16_max = torch.finfo(torch.bfloat16).max
    assert hi[2:n].abs().to(torch.float64).max().item() == bf16_max
    assert torch.equal(hi[n:n + 2].to(torch.float32),
                       torch.tensor([float("inf"), -float("inf")]))
    assert torch.isnan(hi[n + 2])
    assert not bool(mid[n:].any()) and not bool(lo[n:].any())


@pytest.mark.parametrize("L,extremes", [(96, False), (130, False),
                                        (130, True)],
                         ids=["96", "130", "130-extremes"])
def test_split_bf16x3_planes_match_pallas(L, extremes):
    """The kernel's float32 arithmetic on the CPU: the three planes, each
    through the twin's float32 bmm, summed, against the Pallas kernel in
    float32 (interpret mode); with ``extremes``, each protein also holds one
    finite value past bf16's range in a valid row."""
    batch = contact_batch(B=2, L=L, seed=L + 5)
    xs = np.random.default_rng(L).normal(size=(2, L, 40)).astype(np.float32)
    if extremes:
        xs = with_float32_extremes(xs, batch[2])
    ref = np.asarray(jax_gc.graphconv_aggregate(
        *_jax(*batch), jnp.asarray(xs), interpret=True))
    out = sum(gc.graphconv_aggregate_ref(*_torch(*batch), p.to(torch.float32))
              for p in gc._split_bf16x3(torch.from_numpy(xs)))
    assert np.isfinite(ref).all() and bool(torch.isfinite(out).all())
    if extremes:
        assert np.abs(ref).max() >= 3.4e38
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


def _contact_case(case):
    """(coords (B, L, 3) float32, lengths (B,) int32) for the B3 tests.

    L128/L130 are the cases of ``tests/test_pallas.py``'s
    ``test_contact_map_fused_bucket128``; near_threshold puts pairs at
    6 Å ± 1 ulp.
    """
    if case == "near_threshold":
        coords, _, _ = near_threshold_batch(B=2, L=96, seed=6)
        return coords, np.array([96, 61], np.int32)
    L = int(case[1:])
    rng = np.random.default_rng(9)
    coords = np.cumsum(rng.normal(size=(2, L, 3)), axis=1).astype(np.float32)
    return coords, np.asarray([L, L - 7], np.int32)


def _padded_host_maps(coords, lengths):
    """Each protein's numpy ``calculate_contact_map`` (the JAX package's
    host path, which its fine-tuning dataset pads into batches)."""
    out = np.zeros(coords.shape[:2] + coords.shape[1:2], np.float32)
    for b, n in enumerate(lengths):
        out[b, :n, :n] = jax_contact.calculate_contact_map(coords[b, :n])
    return out


@pytest.mark.parametrize("case", ["L128", "L130"])
def test_contact_map_twin_matches_pallas(case):
    """B3's plain twin equals the Pallas kernel (interpret mode), the JAX
    ``batched_contact_maps`` and the padded host maps exactly (atol 0)."""
    coords, lengths = _contact_case(case)
    ref_kernel = np.asarray(jax_contact.contact_map_fused(
        *_jax(coords, lengths), interpret=True))
    ref_xla = np.asarray(jax_contact.batched_contact_maps(
        *_jax(coords, lengths)))
    contact.contact_map_fused.launches = 0
    out = contact.contact_map_fused(*_torch(coords, lengths))
    assert contact.contact_map_fused.launches == 0  # CPU: the twin ran
    assert out.dtype == torch.float32 and out.shape == ref_kernel.shape
    np.testing.assert_allclose(out.numpy(), ref_kernel, rtol=0, atol=0)
    np.testing.assert_allclose(out.numpy(), ref_xla, rtol=0, atol=0)
    np.testing.assert_array_equal(out.numpy(),
                                  _padded_host_maps(coords, lengths))


def test_contact_map_near_threshold():
    """Pairs at 6 Å ± 1 ulp: the twin equals the JAX host maps exactly.

    The JAX device paths differ from the JAX host path there: XLA on the
    CPU contracts the fused distance into fma(dz, dz, fma(dx, dx, dy²)),
    which rounds differently from mul-then-add x, y, z. The port keeps the
    host path's arithmetic (the maps the JAX trainer feeds its model), so
    every pair where it disagrees with a JAX device path must sit within one
    float32 ulp of thr² = 36.
    """
    coords, lengths = _contact_case("near_threshold")
    out = contact.contact_map_fused(*_torch(coords, lengths)).numpy()
    np.testing.assert_array_equal(out, _padded_host_maps(coords, lengths))
    d = (coords[:, :, None, :] - coords[:, None, :, :]).astype(np.float32)
    sq = d * d
    dist = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    ulp = np.spacing(np.float32(36.0))
    for ref in (jax_contact.contact_map_fused(*_jax(coords, lengths),
                                              interpret=True),
                jax_contact.batched_contact_maps(*_jax(coords, lengths))):
        differs = out != np.asarray(ref)
        assert np.all(np.abs(dist[differs] - np.float32(36.0)) <= ulp)


@pytest.mark.parametrize("mode", ["matrix", "sparse"])
def test_calculate_contact_map_matches_jax(mode):
    coords, _ = _contact_case("near_threshold")
    for xyz in (coords[0], coords[1, :61]):
        ref = jax_contact.calculate_contact_map(xyz, mode=mode)
        out = contact.calculate_contact_map(xyz, mode=mode)
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(contact.pairwise_sqeuclidean(coords[0]),
                                  jax_contact.pairwise_sqeuclidean(coords[0]))
    with pytest.raises(ValueError, match="Unsupported distance"):
        contact.calculate_contact_map(coords[0], distance="euclidean")


def test_contact_map_twin_equals_padded_host_maps():
    """The batch map of padded coordinates is each protein's host map,
    zero-padded: the equality the fine-tuning dataset relies on."""
    coords, lengths = _contact_case("near_threshold")
    coords[1, 61:] = 99.0  # padding values must not matter
    out = contact.contact_map_fused(*_torch(coords, lengths)).numpy()
    for b, n in enumerate(lengths):
        want = np.zeros((96, 96), np.float32)
        want[:n, :n] = contact.calculate_contact_map(coords[b, :n])
        np.testing.assert_array_equal(out[b], want)


def test_contact_map_rejects_other_devices():
    with pytest.raises(ValueError, match="no contact-map kernel"):
        contact.contact_map_fused(
            torch.zeros((1, 4, 3), device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"))


def test_batch_tokens_matches_jax():
    seqs = ["MK", "MKVD", "", "ACDEFGHI"]
    for got, ref in zip(one_hot.batch_tokens(seqs, pad_to=8),
                        jax_one_hot.batch_tokens(seqs, pad_to=8)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="exceeds pad_to"):
        one_hot.batch_tokens(["MKVD"], pad_to=3)
    with pytest.raises(ValueError, match="Invalid character"):
        one_hot.batch_tokens(["MK1"], pad_to=8)


ALIGNMENTS = [("ABCDE", "ABCDE"), ("AB-DE", "ABCDE"), ("ABCDE", "AB-DE"),
              ("A-CDE", "ABC-E"), ("AAA--AAAAAA-AAA", "AA-AAAA-AAAAAAA")]


@pytest.mark.parametrize("q_aln,t_aln", ALIGNMENTS)
def test_build_projection_arrays_matches_jax(q_aln, t_aln):
    got = cmap_align.build_projection_arrays(q_aln, t_aln, 16, 16)
    ref = jax_cmap.build_projection_arrays(q_aln, t_aln, 16, 16)
    for g, r in zip(got[:2], ref[:2]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[2] == ref[2]
    with pytest.raises(ValueError, match="pad_q"):
        cmap_align.build_projection_arrays(q_aln, t_aln, 2, 16)
    with pytest.raises(ValueError, match="pad_t"):
        cmap_align.build_projection_arrays(q_aln, t_aln, 16, 2)


@pytest.mark.parametrize("gen", [0, 2])
def test_batched_align_contact_maps_matches_jax(gen):
    """P·A·Pᵀ by torch.bmm against the JAX einsum on the same padded batch
    (exact), and against the host ``align_contact_map`` on each valid
    block."""
    pad_q = pad_t = 24
    rng = np.random.default_rng(gen)
    cases = ALIGNMENTS[1:] + [("AAAAAAAAAAAAAAAAAAAA", "AAAAAAAAAAAAAAAAAAAA")]
    B = len(cases)
    cmaps = np.zeros((B, pad_t, pad_t), np.float32)
    q_to_t = np.zeros((B, pad_q), np.int32)
    ins = np.zeros((B, pad_q), bool)
    qlens = np.zeros(B, np.int32)
    hosts = []
    for b, (q_aln, t_aln) in enumerate(cases):
        tlen = len(t_aln.replace("-", ""))
        steps = rng.normal(size=(tlen, 3))
        steps /= np.linalg.norm(steps, axis=1, keepdims=True)
        xyz = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
        cmaps[b, :tlen, :tlen] = contact.calculate_contact_map(xyz)
        q_to_t[b], ins[b], qlens[b] = cmap_align.build_projection_arrays(
            q_aln, t_aln, pad_q, pad_t)
        hosts.append(cmap_align.align_contact_map(
            q_aln, t_aln, contact.calculate_contact_map(xyz, mode="sparse"),
            generated_contacts=gen))
    ref = np.asarray(jax_cmap.batched_align_contact_maps(
        *_jax(cmaps, q_to_t, ins, qlens), generated_contacts=gen))
    out = cmap_align.batched_align_contact_maps(
        *_torch(cmaps, q_to_t, ins, qlens), generated_contacts=gen)
    assert out.dtype == torch.float32 and out.shape == (B, pad_q, pad_q)
    np.testing.assert_array_equal(out.numpy(), ref)
    for b, host in enumerate(hosts):
        n = qlens[b]
        np.testing.assert_array_equal(out.numpy()[b, :n, :n], host)
        assert not out.numpy()[b, n:].any() and not out.numpy()[b, :, n:].any()
