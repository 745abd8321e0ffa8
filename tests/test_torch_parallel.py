"""The port's multi-device layer (torch.distributed, CPU) against the JAX
package's ``parallel`` on its 8-device CPU mesh.

Ranks are gloo processes started by ``parallel.launch.run_ranks`` (one
world, about 5 s, a group of checks); meshes and shards that need no
collective are checked in this process on PyTorch's in-process ``fake``
process group, one rank at a time. The same numpy inputs and weights go
through both packages. Tolerances: the data- and tensor-parallel forward,
the graph-sharded forward and five training steps' parameters at atol 1e-5
(sums over the model axis and the ring's blocks run in another order than
JAX's); the losses rtol 1e-5; the edge-partitioned aggregate at rtol 1e-5
/ atol 1e-4, as the JAX package's own test.
"""

import contextlib
import dataclasses
import sys
import threading

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import jax
import jax.numpy as jnp

from metagenomic_deepfri_tpu.models import deepfri as jax_deepfri
from metagenomic_deepfri_tpu.ops.cmap_align import \
    aligned_contacts_from_coords as jax_aligned_contacts
from metagenomic_deepfri_tpu.parallel import graph_shard as jax_graph_shard
from metagenomic_deepfri_tpu.parallel import mesh as jax_mesh
from metagenomic_deepfri_tpu.parallel import shard as jax_shard
from metagenomic_deepfri_tpu.parallel import train as jax_train
from metagenomic_deepfri_tpu.parallel.multihost import \
    shard_fasta as jax_shard_fasta
from metagenomic_deepfri_tpu_torch.data.fasta import iter_fasta
from metagenomic_deepfri_tpu_torch.models import deepfri
from metagenomic_deepfri_tpu_torch.ops import contact as contact_ops
from metagenomic_deepfri_tpu_torch.parallel import (graph_shard, launch, mesh,
                                                    multihost, shard, train)
from metagenomic_deepfri_tpu_torch.precision import use_highest_f32_precision

SMALL = dict(n_labels=8, lm_hidden=16, lm_layers=1, embed_dim=32,
             gc_dims=(16, 16), fc_dims=(32, 16))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@contextlib.contextmanager
def _fake_world(rank: int, world: int):
    """This process as rank ``rank`` of a ``world``-rank fake group (no
    collective moves data)."""
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _walk_batch(B, L, seed, short=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 20, (B, L)).astype(np.uint8)
    coords = np.cumsum(rng.normal(size=(B, L, 3)) * 2.0,
                       axis=1).astype(np.float32)
    ins = rng.random((B, L)) < 0.2
    lengths = np.full((B,), L, np.int32)
    lengths[1::2] = L - short
    return tokens, coords, ins, lengths


# ---------------------------------------------------------------------------
# Meshes, specs and shards: one process, fake groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world, mp", [(8, 2), (8, 1), (8, 8), (4, 2),
                                       (1, 1)])
def test_mesh_shapes_match_jax(world, mp):
    """Rank r sits at (r // mp, r % mp), as JAX reshapes its device list."""
    ref = jax_mesh.make_mesh(n_devices=world, model_parallel=mp)
    for r in range(world):
        with _fake_world(r, world):
            m = mesh.make_mesh(model_parallel=mp, device_type="cpu")
            assert tuple(m.mesh.shape) == (ref.shape["data"],
                                           ref.shape["model"])
            assert m.mesh_dim_names == ("data", "model")
            assert (mesh.axis_rank(m, "data"), mesh.axis_rank(m, "model")) \
                == divmod(r, mp)
            assert dist.get_process_group_ranks(
                mesh.axis_group(m, "model")) == list(
                    range(r - r % mp, r - r % mp + mp))
            pod = mesh.make_pod_mesh(model_parallel=mp, device_type="cpu")
            assert tuple(pod.mesh.shape) == tuple(m.mesh.shape)


def test_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match="does not divide"):
        jax_mesh.make_mesh(n_devices=8, model_parallel=3)
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh()
    with _fake_world(0, 8):
        with pytest.raises(ValueError, match="does not divide 8"):
            mesh.make_mesh(model_parallel=3, device_type="cpu")
        with pytest.raises(ValueError, match="only 8 visible"):
            mesh.make_mesh(n_devices=9, device_type="cpu")
        with pytest.raises(ValueError, match="every rank"):
            mesh.make_mesh(n_devices=4, device_type="cpu")
        with pytest.raises(ValueError, match="device type"):
            mesh.make_mesh()  # the fake backend names no device type
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="must not cross hosts"):
            mesh.make_pod_mesh(model_parallel=4, device_type="cpu")
        pod = mesh.make_pod_mesh(model_parallel=2, device_type="cpu")
        assert tuple(pod.mesh.shape) == (4, 2)


def test_param_pspecs_match_jax():
    jcfg = jax_deepfri.GCNConfig(**SMALL)
    params = _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(0), jcfg,
                                           gc_bias=True))
    ref = jax_shard.gcn_param_pspecs(params)

    def split_dim(spec):
        return next((i for i, a in enumerate(spec) if a == "model"), None)

    want = jax.tree_util.tree_map(split_dim, ref,
                                  is_leaf=lambda x: isinstance(
                                      x, jax.sharding.PartitionSpec))
    got = shard.gcn_param_pspecs(params)
    assert jax.tree_util.tree_structure(got, is_leaf=lambda x: x is None) \
        == jax.tree_util.tree_structure(want, is_leaf=lambda x: x is None)
    assert jax.tree_util.tree_leaves(got, is_leaf=lambda x: x is None) \
        == jax.tree_util.tree_leaves(want, is_leaf=lambda x: x is None)
    assert shard.batch_pspecs() == (0, 0, 0)
    assert shard.batch_pspecs(with_adj=False) == (0, 0)
    assert [split_dim(s) for s in jax_shard.batch_pspecs()] == [None] * 3


def test_shard_params_match_jax_shards():
    """Each rank's shards are the JAX NamedSharding's pieces on the device
    at the same (data, model) place of the 4×2 mesh."""
    jcfg = jax_deepfri.GCNConfig(**SMALL)
    params = _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(1), jcfg,
                                           gc_bias=True))
    jmesh = jax_mesh.make_mesh(n_devices=8, model_parallel=2)
    placed = jax_shard.shard_params(params, jmesh)
    grid = jmesh.devices
    for r in range(8):
        d, m = divmod(r, 2)
        with _fake_world(r, 8):
            tmesh = mesh.make_mesh(model_parallel=2, device_type="cpu")
            local = shard.shard_params(params, tmesh, device="cpu")
        want = jax.tree_util.tree_map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == grid[d, m])), placed)
        for g, w in zip(jax.tree_util.tree_leaves(local),
                        jax.tree_util.tree_leaves(want), strict=True):
            np.testing.assert_array_equal(g.numpy(), w)


def test_shard_fasta_for_process_partitions(tmp_path):
    """World 2: each rank writes its own slice and the slices partition the
    input, as the JAX ``shard_fasta`` cuts it; no group is shard 0 of 1."""
    rng = np.random.default_rng(0)
    fasta = tmp_path / "in.faa"
    fasta.write_text("".join(
        f">q{i}\n{''.join(rng.choice(list('ACDEFGHIKLMNPQRSTVWY'), 30))}\n"
        for i in range(40)))
    shards = []
    for r in range(2):
        with _fake_world(r, 2):
            out, n = multihost.shard_fasta_for_process(
                fasta, tmp_path / f"p{r}.faa")
        ref, n_ref = jax_shard_fasta(fasta, tmp_path / f"j{r}.faa", r, 2)
        assert n == n_ref and out.read_text() == ref.read_text()
        shards.append(dict(iter_fasta(out)))
    assert not set(shards[0]) & set(shards[1])
    assert {**shards[0], **shards[1]} == dict(iter_fasta(fasta))
    out, n = multihost.shard_fasta_for_process(fasta, tmp_path / "all.faa")
    assert n == 40 and dict(iter_fasta(out)) == dict(iter_fasta(fasta))


def test_device_lists():
    assert launch.device_list("cpu") == [torch.device("cpu")]
    assert launch.device_list("cpu, cpu") == [torch.device("cpu")] * 2
    assert launch.device_list(torch.device("cuda:1")) == [
        torch.device("cuda:1")]
    with pytest.raises(ValueError, match="one type"):
        launch.device_list(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="no device"):
        launch.device_list(" , ")
    # no CUDA device here: a list of cards names ones that do not exist
    with pytest.raises(ValueError, match="do not exist"):
        launch.device_list("cuda:0,cuda:1")
    with pytest.raises((ValueError, RuntimeError)):
        launch.run_ranks(shard._sharded_forward_rank, ["cuda:0"])


def test_count_launch_is_thread_safe():
    """More threads than cores adding to one counter, with a short switch
    interval: no update is lost."""
    def fn():
        pass

    fn.launches = 0
    n_threads, per_thread = 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            contact_ops.count_launch(fn) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == n_threads * per_thread


# ---------------------------------------------------------------------------
# Ranks: gloo worlds against the JAX mesh
# ---------------------------------------------------------------------------


def test_sharded_forward_matches_jax():
    """2×2 ranks (data 2, model 2; two FC layers, so the all-gather between
    them runs) against JAX ``make_sharded_gcn_forward`` on its 4×2 mesh."""
    use_highest_f32_precision()
    jcfg = jax_deepfri.GCNConfig(**SMALL)
    params = _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(2), jcfg,
                                           gc_bias=True))
    tokens, coords, ins, lengths = _walk_batch(8, 16, seed=2)
    adj = np.asarray(jax_aligned_contacts(jnp.asarray(coords),
                                          jnp.asarray(ins),
                                          jnp.asarray(lengths)))
    jmesh = jax_mesh.make_mesh(n_devices=8, model_parallel=2)
    fwd = jax_shard.make_sharded_gcn_forward(jmesh, jcfg, params)
    ref = np.asarray(fwd(jax_shard.shard_params(params, jmesh), tokens, adj,
                         lengths))
    got = shard.sharded_gcn_forward(
        ["cpu"] * 4, deepfri.GCNConfig(**dataclasses.asdict(jcfg)), params,
        tokens, adj, lengths, model_parallel=2)
    assert got.shape == (8, SMALL["n_labels"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_edge_partitioned_aggregate_matches_jax():
    B, L, D = 2, 64, 16
    rng = np.random.default_rng(9)
    _, coords, ins, lengths = _walk_batch(B, L, seed=9, short=10)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    jmesh = jax_mesh.make_mesh(n_devices=8, model_parallel=8)
    ref = np.asarray(jax_graph_shard.make_edge_partitioned_aggregate(
        jmesh, L, D)(jnp.asarray(coords), jnp.asarray(ins, jnp.float32),
                     jnp.asarray(lengths), jnp.asarray(x)))
    got = graph_shard.edge_partitioned_aggregate(["cpu"] * 4, coords, ins,
                                                 lengths, x)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("adj_norm, pool", [("sym", "sum"), ("row", "mean")])
def test_graph_sharded_forward_matches_jax(adj_norm, pool):
    use_highest_f32_precision()
    jcfg = jax_deepfri.GCNConfig(n_labels=6, lm_hidden=8, lm_layers=1,
                                 embed_dim=16, gc_dims=(8, 8),
                                 fc_dims=(16,), adj_norm=adj_norm, pool=pool)
    params = _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(3), jcfg))
    tokens, coords, ins, lengths = _walk_batch(2, 32, seed=3)
    jmesh = jax_mesh.make_mesh(n_devices=8, model_parallel=8)
    ref = np.asarray(jax_graph_shard.make_graph_sharded_gcn_forward(
        jmesh, jcfg, 32)(params, jnp.asarray(tokens), jnp.asarray(coords),
                         jnp.asarray(ins), jnp.asarray(lengths)))
    got = graph_shard.graph_sharded_gcn_forward(
        ["cpu"] * 4, deepfri.GCNConfig(**dataclasses.asdict(jcfg)), params,
        tokens, coords, ins, lengths)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_train_steps_match_jax():
    """Five steps on a 2×2 world against JAX ``make_train_step`` on its
    4×2 mesh from the same weights and batches."""
    use_highest_f32_precision()
    jcfg = jax_deepfri.GCNConfig(**SMALL, adj_norm="sym")
    params = _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(4), jcfg,
                                           gc_bias=True))
    rng = np.random.default_rng(4)
    batches = []
    for s in range(5):
        tokens, coords, ins, lengths = _walk_batch(8, 16, seed=10 + s)
        adj = np.asarray(jax_aligned_contacts(
            jnp.asarray(coords), jnp.asarray(ins), jnp.asarray(lengths)))
        labels = (rng.random((8, SMALL["n_labels"])) < 0.4).astype(np.int32)
        batches.append((tokens, adj, lengths, labels))
    jmesh = jax_mesh.make_mesh(n_devices=8, model_parallel=2)
    opt = optax.adam(1e-3)
    state = jax_train.init_train_state(None, jcfg, opt, mesh=jmesh,
                                       params=params)
    step = jax_train.make_train_step(jmesh, jcfg, opt)
    ref_losses = []
    for b in batches:
        state, loss = step(state, *b)
        ref_losses.append(float(loss))
    ref = _np_tree(state.params)
    losses, full = train.train_steps(
        ["cpu"] * 4, deepfri.GCNConfig(**dataclasses.asdict(jcfg)), params,
        batches, 1e-3, model_parallel=2)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for g, r in zip(jax.tree_util.tree_leaves(full),
                    jax.tree_util.tree_leaves(ref), strict=True):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)


def test_failing_rank_fails_the_call():
    """A rank's own exception reaches the caller: L = 64 over 3 ranks."""
    _, coords, ins, lengths = _walk_batch(1, 64, seed=5)
    x = np.zeros((1, 64, 4), np.float32)
    with pytest.raises(ValueError, match="not divisible by axis size 3"):
        graph_shard.edge_partitioned_aggregate(["cpu"] * 3, coords, ins,
                                               lengths, x)
