"""Fine-tuning of the port: labelled structures → updated GCN weights.

Counterpart of ``metagenomic_deepfri_tpu/training.py``:

- **data**: a directory of structure files (.pdb/.cif[.gz], one per protein;
  sequence and coordinates both come from the structure) plus a labels TSV
  (``protein<TAB>GO:...;GO:...``). Labels are indexed against the base
  model's ``goterms`` vocabulary; unknown terms warn and drop.
- **batching**: the same length buckets, shuffle and repeat-fill as the JAX
  dataset, so both packages see the same batches for the same seed. The JAX
  dataset builds each protein's L×L contact map on the host at load time;
  here the dataset keeps the CA coordinates, and each padded batch's
  (B, bucket, bucket) adjacency is built on the device by one launch of the
  B3 contact-map kernel (:func:`..ops.contact.contact_map_fused`), equal
  entry for entry to the host maps.
- **training**: :mod:`.parallel.train`, on one device in this process, or
  over a device list with one rank a device (:mod:`.parallel.launch`) on a
  (data, model) mesh: every rank draws the same batches with the same seed
  and keeps its data slice, whose adjacency B3 builds on the rank's own
  card; rank 0 gathers the parameters and writes the outputs.
- **output**: a native ``.npz`` checkpoint plus an ONNX re-export with the
  model-params JSON, named as the JAX package names them, so the fine-tuned
  model drops back into ``model_config.json`` / either registry.
"""

from __future__ import annotations

import json
import logging
import warnings
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from metagenomic_deepfri_tpu_torch.batching.buckets import (DEFAULT_BUCKETS,
                                                            bucket_plan)
from metagenomic_deepfri_tpu_torch.data.structures import (
    get_residues_coordinates, load_structure, read_structure_file,
    structure_id_and_type)
from metagenomic_deepfri_tpu_torch.models.convert import gcn_params_to_numpy
from metagenomic_deepfri_tpu_torch.models.onnx_import import \
    export_gcn_to_onnx
from metagenomic_deepfri_tpu_torch.models.registry import (load_model_handle,
                                                           save_checkpoint)
from metagenomic_deepfri_tpu_torch.ops.contact import contact_map_fused
from metagenomic_deepfri_tpu_torch.ops.one_hot import seq2tokens
from metagenomic_deepfri_tpu_torch.parallel.launch import (device_list,
                                                           run_ranks)
from metagenomic_deepfri_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                         axis_rank,
                                                         axis_size, make_mesh)
from metagenomic_deepfri_tpu_torch.parallel.shard import (gather_params,
                                                          gcn_param_pspecs)
from metagenomic_deepfri_tpu_torch.parallel.train import (init_train_state,
                                                          make_train_step)
from metagenomic_deepfri_tpu_torch.precision import use_highest_f32_precision
from metagenomic_deepfri_tpu_torch.utils import load_deepfri_config

logger = logging.getLogger(__name__)


def load_labels(labels_path, goterms: List[str]) -> Dict[str, np.ndarray]:
    """Parse a ``protein<TAB>term[;term...]`` TSV into multi-hot rows.

    Terms outside the model vocabulary warn once each and are dropped —
    fine-tuning cannot grow the head (the reference's per-model
    ``goterms`` list is fixed at export, reference ``utils.py:371-389``).
    """
    index = {t: i for i, t in enumerate(goterms)}
    unknown = set()
    out: Dict[str, np.ndarray] = {}
    with open(labels_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                continue
            pid, terms = parts[0], parts[1]
            row = out.setdefault(pid, np.zeros(len(goterms), np.int32))
            for term in terms.replace(",", ";").split(";"):
                term = term.strip()
                if not term:
                    continue
                if term in index:
                    row[index[term]] = 1
                elif term not in unknown:
                    unknown.add(term)
                    warnings.warn(f"Label term {term} not in the model "
                                  "vocabulary; dropped.")
    return out


class FineTuneDataset:
    """Structures + labels → shuffled, bucketed, padded training batches."""

    def __init__(self, structures_dir, labels: Dict[str, np.ndarray],
                 contact_threshold: float = 6.0,
                 buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        self.contact_threshold = float(contact_threshold)
        # (tokens (L,) uint8, CA coords (L, 3) float32, labels (n_labels,))
        self.items: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        structures_dir = Path(structures_dir)
        for f in sorted(structures_dir.iterdir()):
            sid, _ = structure_id_and_type(f.name)
            if sid is None or sid not in labels:
                continue
            try:
                text, ftype = read_structure_file(f)
                table = load_structure(text, filetype=ftype)
                seq, coords = get_residues_coordinates(
                    table, chain=table.chains()[0])
            except (KeyError, ValueError, IndexError) as e:
                warnings.warn(f"Skipping training structure {f.name}: {e}")
                continue
            if not seq:
                continue
            self.items.append((seq2tokens(seq),
                               np.asarray(coords, np.float32), labels[sid]))
        if not self.items:
            raise ValueError(
                f"No labelled structures found in {structures_dir}")
        logger.info("Fine-tune dataset: %d labelled structures.",
                    len(self.items))

    def batch_plan(self, batch_size: int, rng: np.random.Generator
                   ) -> Iterator[Tuple[int, List[int]]]:
        """Yield (bucket, item indices) per batch, in training order.

        Items are shuffled, grouped per length bucket, and partial batches
        repeat earlier items to fill the static shape (drop-nothing padding
        for tiny fine-tuning sets). Draws from ``rng`` exactly as the JAX
        dataset's ``iter_batches`` does.
        """
        order = rng.permutation(len(self.items))
        plan = bucket_plan([self.items[i][0].shape[0] for i in order],
                           self.buckets)
        for bucket in sorted(plan):
            idxs = [order[i] for i in plan[bucket]]
            for start in range(0, len(idxs), batch_size):
                chunk = idxs[start:start + batch_size]
                while len(chunk) < batch_size:  # repeat-fill partial batch
                    chunk = list(chunk) + list(
                        chunk[: batch_size - len(chunk)])
                yield bucket, chunk

    def iter_batches(self, batch_size: int, rng: np.random.Generator,
                     device, shard: Tuple[int, int] = (0, 1)):
        """Yield (tokens, adjacency, lengths, labels) batches on ``device``.

        Shapes and dtypes as the JAX dataset's: tokens (n, bucket) uint8,
        adjacency (n, bucket, bucket) float32 0/1 with padded rows and
        columns zeroed, lengths (n,) int32, labels (n, n_labels) int32. The
        adjacency comes from one :func:`..ops.contact.contact_map_fused`
        call on the padded coordinates (the B3 kernel on a CUDA device).
        ``shard=(index, count)`` keeps the index-th of ``count`` equal
        contiguous slices of every batch (``batch_size`` a multiple of
        ``count``), before anything reaches the device.
        """
        device = torch.device(device)
        n_labels = self.items[0][2].shape[0]
        index, count = shard
        if batch_size % count:
            raise ValueError(f"batch_size {batch_size} does not split into "
                             f"{count} slices")
        part = batch_size // count
        for bucket, chunk in self.batch_plan(batch_size, rng):
            chunk = chunk[index * part:(index + 1) * part]
            n = len(chunk)
            tokens = np.zeros((n, bucket), np.uint8)
            coords = np.zeros((n, bucket, 3), np.float32)
            lengths = np.zeros((n,), np.int32)
            labels = np.zeros((n, n_labels), np.int32)
            for j, idx in enumerate(chunk):
                t, xyz, lab = self.items[idx]
                L = t.shape[0]
                tokens[j, :L] = t
                coords[j, :L] = xyz
                lengths[j] = L
                labels[j] = lab
            tokens, coords, lengths, labels = (
                torch.from_numpy(a).to(device)
                for a in (tokens, coords, lengths, labels))
            adj = contact_map_fused(coords, lengths, self.contact_threshold)
            yield tokens, adj, lengths, labels


def _base_model(weights, mode: str):
    """(handle, goterms) of one mode's base GCN from a weights folder."""
    models_config = load_deepfri_config(weights)
    if mode not in models_config["gcn"]:
        raise ValueError(f"No GCN weights for mode {mode!r} in {weights}")
    model_path = models_config["gcn"][mode]
    params_json = str(Path(model_path).with_suffix("")) + "_model_params.json"
    logger.info("Loading gcn/%s from %s", mode, model_path)
    handle = load_model_handle("gcn", mode, model_path, params_json)
    goterms = handle.goterms or [str(i) for i in range(handle.config.n_labels)]
    return handle, goterms


def _train_epochs(step, state, dataset: FineTuneDataset, batch_size: int,
                  rng, device, epochs: int, log_every: int, on_step,
                  shard: Tuple[int, int] = (0, 1)):
    """The epochs of a run: every batch through ``step``; returns (state,
    last epoch's mean loss)."""
    step_idx = 0
    last_loss = float("nan")
    for epoch in range(epochs):
        losses = []
        for tokens, adj, lengths, lab in dataset.iter_batches(
                batch_size, rng, device, shard):
            state, loss = step(state, tokens, adj, lengths, lab)
            losses.append(loss)
            step_idx += 1
            if on_step is not None:
                on_step(step_idx, loss)
            if step_idx % log_every == 0:
                logger.info("step %d: loss %.4f", step_idx, float(loss))
        last_loss = float(np.mean([float(l) for l in losses]))
        logger.info("epoch %d/%d: mean loss %.4f",
                    epoch + 1, epochs, last_loss)
    return state, last_loss


def _write_outputs(output_dir, mode: str, config, params: dict, handle,
                   goterms: list, contact_threshold: float) -> Path:
    """The ``.npz`` checkpoint, ONNX re-export and params JSON of a run."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    ckpt_path = output_dir / f"gcn_{mode}_finetuned.npz"
    save_checkpoint(ckpt_path, config, params)
    onnx_name = (f"DeepFRI-FINETUNED_GraphConv_"
                 f"gcd_{'-'.join(map(str, config.gc_dims))}_"
                 f"fcd_{'-'.join(map(str, config.fc_dims))}_ca_"
                 f"{contact_threshold}_{mode}.onnx")
    onnx_path = output_dir / onnx_name
    export_gcn_to_onnx(params, config, str(onnx_path))
    with open(output_dir / (onnx_name[:-5] + "_model_params.json"), "w",
              encoding="utf-8") as f:
        json.dump({"goterms": goterms,
                   "gonames": handle.gonames or [""] * len(goterms)}, f)
    return ckpt_path


def _finetune_rank(device, weights, mode, structures_dir, labels_path,
                   output_dir, epochs, learning_rate, batch_size,
                   contact_threshold, model_parallel, seed, log_every):
    """One rank of a run over several devices: its shards and data slice;
    rank 0 returns (every step's loss, the checkpoint path)."""
    handle, goterms = _base_model(weights, mode)
    config = handle.config
    dataset = FineTuneDataset(structures_dir,
                              load_labels(labels_path, goterms),
                              contact_threshold=contact_threshold)
    mesh = make_mesh(model_parallel=model_parallel)
    dp = axis_size(mesh, DATA_AXIS)
    if batch_size % dp:  # as the JAX finetune rounds to the data axis
        batch_size += dp - batch_size % dp
    if config.compute_dtype == "float32":
        use_highest_f32_precision()
    state = init_train_state(config, learning_rate, device,
                             params=handle.params, mesh=mesh)
    losses = []
    state, last_loss = _train_epochs(
        make_train_step(config, mesh), state, dataset, batch_size,
        np.random.default_rng(seed), device, epochs, log_every,
        lambda i, loss: losses.append(loss),
        shard=(axis_rank(mesh, DATA_AXIS), dp))
    params = gather_params(state.params, mesh,
                           gcn_param_pspecs(handle.params))
    if dist.get_rank() != 0:
        return None
    ckpt_path = _write_outputs(output_dir, mode, config, params, handle,
                               goterms, contact_threshold)
    logger.info("Fine-tuned %s over %d devices (model_parallel %d): final "
                "mean loss %.4f → %s", mode, dist.get_world_size(),
                model_parallel, last_loss, ckpt_path)
    return [float(l) for l in losses], ckpt_path


def finetune(weights,
             mode: str,
             structures_dir,
             labels_path,
             output_dir,
             *,
             device,
             epochs: int = 5,
             learning_rate: float = 1e-4,
             batch_size: int = 8,
             contact_threshold: float = 6.0,
             model_parallel: int = 1,
             seed: int = 0,
             log_every: int = 10,
             on_step: Optional[Callable[[int, torch.Tensor], None]] = None
             ) -> Path:
    """Fine-tune one mode's GCN on ``device``; returns the checkpoint path.

    Loads the base GCN through the ONNX registry, trains with
    :mod:`.parallel.train`, and writes a native ``.npz`` checkpoint (with its
    ``_config.json``) plus an ONNX re-export and params JSON compatible with
    the inference pipeline's ``model_config.json`` layout.

    ``device`` is one device, or a list (``["cuda:0", "cuda:1"]``,
    ``"cuda:0,cuda:1"``) to train over one rank a device on a (data,
    model) mesh with ``model_parallel`` ranks along the model axis, which
    must divide the device count (``ValueError`` otherwise, as the JAX
    ``make_mesh``); ``batch_size`` is then rounded up to a multiple of the
    data axis. ``on_step``, if given, is called with each step's 1-based
    index and detached loss tensor (reading it synchronises the device):
    after every step on one device, after the run over several.
    """
    devices = device_list(device)
    if model_parallel < 1 or len(devices) % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"{len(devices)} devices")
    if len(devices) > 1:
        losses, ckpt_path = run_ranks(
            _finetune_rank, devices, weights, mode, structures_dir,
            labels_path, output_dir, epochs, learning_rate, batch_size,
            contact_threshold, model_parallel, seed, log_every)[0]
        if on_step is not None:
            for i, loss in enumerate(losses, start=1):
                on_step(i, torch.tensor(loss))
        return ckpt_path

    device = devices[0]
    handle, goterms = _base_model(weights, mode)
    config = handle.config
    labels = load_labels(labels_path, goterms)
    dataset = FineTuneDataset(structures_dir, labels,
                              contact_threshold=contact_threshold)

    if config.compute_dtype == "float32":
        use_highest_f32_precision()
    state = init_train_state(config, learning_rate, device,
                             params=handle.params)
    state, last_loss = _train_epochs(
        make_train_step(config), state, dataset, batch_size,
        np.random.default_rng(seed), device, epochs, log_every, on_step)
    ckpt_path = _write_outputs(output_dir, mode, config,
                               gcn_params_to_numpy(state.params), handle,
                               goterms, contact_threshold)
    logger.info("Fine-tuned %s: final mean loss %.4f → %s",
                mode, last_loss, ckpt_path)
    return ckpt_path
