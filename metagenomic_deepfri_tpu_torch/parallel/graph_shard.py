"""Edge-partitioned GraphConv aggregation across ranks: the long-protein
forward.

Counterpart of ``metagenomic_deepfri_tpu/parallel/graph_shard.py:34-272``.
The node dimension of a batch is split over one mesh axis: each rank holds
L/n rows of the GraphConv state and computes its rows of ``Â·X`` while the
feature shards travel a ring of point-to-point exchanges
(``dist.batch_isend_irecv``), each exchange posted before the local block
product so that the transfer overlaps it.

The adjacency is never communicated: each rank rebuilds its (own rows ×
visiting columns) block from the replicated O(L) projected coordinates
(:func:`_contact_block`, the exact per-axis difference form). Per ring step
a rank sends and receives one (B, L/n, D) feature shard; n − 1 exchanges
bring every shard past every rank (the JAX ring makes n, the last one
unused), and a world of one exchanges nothing.

The degrees come from the B2 kernel (:func:`..ops.graphconv.
contact_degrees`) on the replicated coordinates, all L rows on every rank,
instead of the JAX package's per-rank row sums and all-gather: the counts
are integers in float32, so the vector is the same bit for bit, and no
collective is needed. The per-step block product is a plain ``torch.bmm``,
as the JAX package's is a plain ``einsum`` outside any Pallas kernel.

The per-rank functions (:func:`make_edge_partitioned_aggregate`,
:func:`make_graph_sharded_gcn_forward`) run inside a process group on a
mesh from :mod:`.mesh`; :func:`edge_partitioned_aggregate` and
:func:`graph_sharded_gcn_forward` are their one-process forms over a device
list (:func:`.launch.run_ranks`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from metagenomic_deepfri_tpu_torch.models.deepfri import (_dense, _fc_stack,
                                                          _head_scores,
                                                          _masked_onehot,
                                                          graphconv_apply)
from metagenomic_deepfri_tpu_torch.models.convert import (gcn_params_from_numpy,
                                                          gcn_params_to_numpy)
from metagenomic_deepfri_tpu_torch.models.lstm import lstm_stack_forward
from metagenomic_deepfri_tpu_torch.ops.cmap_align import _SENTINEL_BASE
from metagenomic_deepfri_tpu_torch.ops.contact import _thr2
from metagenomic_deepfri_tpu_torch.ops.graphconv import contact_degrees
from metagenomic_deepfri_tpu_torch.parallel.launch import run_ranks
from metagenomic_deepfri_tpu_torch.parallel.mesh import (MODEL_AXIS,
                                                         axis_group,
                                                         axis_rank,
                                                         axis_size, make_mesh)


def _contact_block(coords, ins_mask, lengths, r0: int, c0: int, Ls: int,
                   threshold: float, generated_contacts: int):
    """(B, Ls, Ls) float32 block A[:, r0:r0+Ls, c0:c0+Ls] of the aligned
    adjacency: contacts between real positions (the float32 per-axis
    difference form, summed x, y, z), the diagonal, the insertion band, and
    the length mask, as ``aligned_contacts_from_coords``."""
    rows = coords[:, r0:r0 + Ls]
    cols = coords[:, c0:c0 + Ls]
    ins_r = ins_mask[:, r0:r0 + Ls].to(torch.bool)
    ins_c = ins_mask[:, c0:c0 + Ls].to(torch.bool)
    dist2 = torch.zeros((coords.shape[0], Ls, Ls), dtype=torch.float32,
                        device=coords.device)
    for k in range(3):
        d = rows[:, :, k][:, :, None] - cols[:, :, k][:, None, :]
        dist2 = dist2 + d * d
    contact = dist2 < _thr2(threshold)
    real_r = rows[:, :, 0] < _SENTINEL_BASE * 0.5
    real_c = cols[:, :, 0] < _SENTINEL_BASE * 0.5
    contact = contact & real_r[:, :, None] & real_c[:, None, :]

    pos = torch.arange(Ls, dtype=torch.int64, device=coords.device)
    row_ids = (r0 + pos)[None, :, None]
    col_ids = (c0 + pos)[None, None, :]
    offset = (row_ids - col_ids).abs()
    band = (offset > 0) & (offset <= generated_contacts)
    ins_pairs = band & (ins_r[:, :, None] | ins_c[:, None, :])
    n = lengths.to(torch.int64)[:, None, None]
    valid = (row_ids < n) & (col_ids < n)
    return ((contact | (row_ids == col_ids) | ins_pairs)
            & valid).to(torch.float32)


class _Ring:
    """This rank's place on the ring of ``axis``: its index, the ring's
    size, the shard length, and the group's global ranks."""

    def __init__(self, mesh, L: int, axis: str):
        self.n = axis_size(mesh, axis)
        if L % self.n:
            raise ValueError(f"L={L} not divisible by axis size {self.n}")
        self.k = axis_rank(mesh, axis)
        self.Ls = L // self.n
        self.r0 = self.k * self.Ls
        self.group = axis_group(mesh, axis)
        self.ranks = dist.get_process_group_ranks(self.group)

    def aggregate(self, coords, ins_mask, lengths, x_shard, threshold: float,
                  generated_contacts: int) -> torch.Tensor:
        """This rank's rows of Â·x: (B, Ls, D) float32 from its (B, Ls, D)
        shard of x."""
        n, k, Ls = self.n, self.k, self.Ls
        cur = x_shard.to(torch.float32).contiguous()
        acc = torch.zeros_like(cur)
        for step in range(n):
            pending = []
            if step < n - 1:  # post the exchange before the block product
                nxt = torch.empty_like(cur)
                pending = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, cur, self.ranks[(k - 1) % n],
                               self.group),
                    dist.P2POp(dist.irecv, nxt, self.ranks[(k + 1) % n],
                               self.group)])
            # after `step` exchanges this rank holds shard (k + step) mod n
            src = (k + step) % n
            block = _contact_block(coords, ins_mask, lengths, self.r0,
                                   src * Ls, Ls, threshold,
                                   generated_contacts)
            acc = acc + torch.bmm(block, cur)
            for req in pending:
                req.wait()
            if pending:
                cur = nxt
        return acc


def make_edge_partitioned_aggregate(mesh, L: int, D: int,
                                    threshold: float = 6.0,
                                    generated_contacts: int = 2,
                                    axis: str = MODEL_AXIS):
    """The node-sharded aggregation out = Â(coords)·x of one rank.

    Returns ``fn(coords (B, L, 3), ins_mask (B, L), lengths (B,), x_shard
    (B, L/n, D)) -> (B, L/n, D)``: coordinates, insertion mask and lengths
    replicated, ``x`` and the output split over ``axis`` (this rank's rows
    ``[k·L/n, (k+1)·L/n)``). ``L % n != 0`` raises ``ValueError``.
    """
    del D  # the feature width is read from x
    ring = _Ring(mesh, L, axis)

    def fn(coords, ins_mask, lengths, x_shard):
        return ring.aggregate(coords, ins_mask, lengths, x_shard, threshold,
                              generated_contacts)

    return fn


def make_graph_sharded_gcn_forward(mesh, config, L: int,
                                   threshold: float = 6.0,
                                   generated_contacts: int = 2,
                                   axis: str = MODEL_AXIS):
    """The whole GCN forward of one rank with the node dimension split over
    ``axis``.

    Returns ``fn(params, tokens (B, L) uint8, coords (B, L, 3), ins_mask
    (B, L) bool, lengths (B,) int32) -> (B, n_labels)`` float32 scores,
    replicated; ``params`` is the full tree on this rank's device. The
    LSTM-LM runs replicated (a recurrence has no parallelism along the
    sequence); each rank then keeps its L/n rows, aggregates them over the
    ring, and the pooled rows are summed over ``axis``; the FC stack and
    head run replicated. Everything computes in float32, as the JAX
    function does. The same math as ``gcn_forward`` on
    ``aligned_contacts_from_coords``; ``L % n != 0`` raises ``ValueError``.
    """
    ring = _Ring(mesh, L, axis)
    lo, hi = ring.r0, ring.r0 + ring.Ls

    def fn(params, tokens, coords, ins_mask, lengths):
        onehot, valid = _masked_onehot(tokens, lengths, torch.float32)
        lm_out = lstm_stack_forward(params["lm"], onehot, lengths)
        x_full = torch.relu(_dense(params["lm_embed"], lm_out)
                            + _dense(params["aa_embed"], onehot))
        x = x_full[:, lo:hi]
        deg = contact_degrees(coords, ins_mask, lengths, threshold,
                              generated_contacts)
        zero = torch.zeros_like(deg)
        if config.adj_norm == "sym":
            col_scale = row_scale = torch.where(
                deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), zero)
        elif config.adj_norm == "row":
            row_scale = torch.where(deg > 0, 1.0 / deg.clamp_min(1e-12),
                                    zero)
            col_scale = torch.ones_like(deg)
        elif config.adj_norm == "none":
            col_scale = row_scale = torch.ones_like(deg)
        else:
            raise ValueError(
                f"Unknown adjacency normalisation: {config.adj_norm}")
        row_own = row_scale[:, lo:hi, None]
        col_own = col_scale[:, lo:hi, None]
        gc_outputs = []
        for layer in params["gc"]:
            agg = ring.aggregate(coords, ins_mask, lengths, x * col_own,
                                 threshold, generated_contacts) * row_own
            x = graphconv_apply(layer, agg, torch.float32)
            gc_outputs.append(x)
        concat = torch.cat(gc_outputs, dim=-1)
        pooled = (concat * valid[:, lo:hi, None]).sum(dim=1)
        if ring.n > 1:
            dist.all_reduce(pooled, group=ring.group)
        if config.pool == "mean":
            pooled = pooled / lengths.clamp_min(1).to(pooled.dtype)[:, None]
        elif config.pool != "sum":
            raise ValueError(f"Unknown pooling mode: {config.pool}")
        return _head_scores(params["head"], _fc_stack(params["fc"], pooled),
                            config.n_labels)

    return fn


def _on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _aggregate_rank(device, coords, ins_mask, lengths, x, threshold,
                    generated_contacts):
    mesh = make_mesh(model_parallel=dist.get_world_size())
    L = coords.shape[1]
    fn = make_edge_partitioned_aggregate(mesh, L, x.shape[-1], threshold,
                                         generated_contacts)
    n, k = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    Ls = L // n
    c, ins, ln, xs = _on(device, coords, ins_mask, lengths,
                         x[:, k * Ls:(k + 1) * Ls])
    with torch.no_grad():
        return fn(c, ins, ln, xs).cpu().numpy()


def edge_partitioned_aggregate(devices, coords, ins_mask, lengths, x,
                               threshold: float = 6.0,
                               generated_contacts: int = 2) -> np.ndarray:
    """One-process form: Â·x as (B, L, D) float32 numpy, the node dimension
    split over one rank a listed device (all on the model axis)."""
    parts = run_ranks(_aggregate_rank, devices, np.asarray(coords, np.float32),
                      np.asarray(ins_mask, bool), np.asarray(lengths, np.int32),
                      np.asarray(x, np.float32), threshold,
                      generated_contacts)
    return np.concatenate(parts, axis=1)


def _forward_rank(device, config, params, tokens, coords, ins_mask, lengths,
                  threshold, generated_contacts):
    mesh = make_mesh(model_parallel=dist.get_world_size())
    fn = make_graph_sharded_gcn_forward(mesh, config, coords.shape[1],
                                        threshold, generated_contacts)
    with torch.no_grad():
        out = fn(gcn_params_from_numpy(params, device),
                 *_on(device, tokens, coords, ins_mask, lengths))
    return out.cpu().numpy() if dist.get_rank() == 0 else None


def graph_sharded_gcn_forward(devices, config, params: dict, tokens, coords,
                              ins_mask, lengths, threshold: float = 6.0,
                              generated_contacts: int = 2) -> np.ndarray:
    """One-process form: (B, n_labels) scores of the graph-sharded forward
    over one rank a listed device (all on the model axis)."""
    return run_ranks(_forward_rank, devices, config,
                     gcn_params_to_numpy(params),
                     np.asarray(tokens, np.uint8),
                     np.asarray(coords, np.float32),
                     np.asarray(ins_mask, bool), np.asarray(lengths, np.int32),
                     threshold, generated_contacts)[0]
