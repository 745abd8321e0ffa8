"""Seeded synthetic inputs (numpy) for parity tests and the GPU smoke run.

Published weights and structures are not needed: every input here is built
from a seed, so the JAX package and the port can be handed identical arrays.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from metagenomic_deepfri_tpu_torch.data.structures import write_ca_pdb
from metagenomic_deepfri_tpu_torch.models.convert import gcn_params_to_numpy
from metagenomic_deepfri_tpu_torch.models.onnx_import import \
    export_gcn_to_onnx
from metagenomic_deepfri_tpu_torch.models.tf2onnx_fixture import (
    export_cnn_tf2onnx_style, export_gcn_tf2onnx_style)
from metagenomic_deepfri_tpu_torch.ops.cmap_align import (
    _SENTINEL_BASE, _SENTINEL_SPACING, project_alignment_coords)

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"


def contact_batch(B: int = 2, L: int = 128, seed: int = 0, n_ins: int = 3):
    """Random-walk CA chains with sentinels and insertions.

    The same generator as the JAX package's ``tests/test_pallas.py::_mk_batch``:
    lengths in [L/2, L], 3.8 Å steps, two unmapped (sentinel) positions and
    ``n_ins`` insertion positions per protein. Returns numpy
    ``coords (B, L, 3) float32, ins (B, L) bool, lengths (B,) int32``.
    """
    rng = np.random.default_rng(seed)
    coords = np.zeros((B, L, 3), np.float32)
    ins = np.zeros((B, L), bool)
    lengths = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    for b in range(B):
        n = lengths[b]
        steps = rng.normal(size=(n, 3)).astype(np.float32)
        steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
        coords[b, :n] = np.cumsum(3.8 * steps, axis=0)
        unmapped = rng.choice(n, size=2, replace=False)
        coords[b, unmapped] = 0.0
        coords[b, unmapped, 0] = (_SENTINEL_BASE
                                  + _SENTINEL_SPACING * unmapped)
        ins[b, rng.choice(n, size=n_ins, replace=False)] = True
    return coords, ins, lengths


def _sqdist_f32(p: np.ndarray, q: np.ndarray) -> np.float32:
    """Squared distance in float32, multiplied then added x, y, z in order."""
    d = (p - q).astype(np.float32)
    return np.float32(np.float32(d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])


def near_threshold_batch(B: int = 4, L: int = 512, seed: int = 0,
                         threshold: float = 6.0):
    """Points whose float32 distance² to row 0 sits within an ulp of thr².

    Row 0 of each protein is a centre; every other row lies in a random
    direction at distance ≈ threshold, with its x nudged by single ulps until
    the float32 squared distance (mul-then-add, x, y, z) is thr² − 1 ulp,
    thr² or thr² + 1 ulp. An FMA-contracted distance rounds differently and
    flips some of these pairs. Returns the same triple as
    :func:`contact_batch`, with full lengths and no insertions.
    """
    rng = np.random.default_rng(seed)
    thr2 = np.float32(threshold * threshold)
    targets = (np.nextafter(thr2, np.float32(0)), thr2,
               np.nextafter(thr2, np.float32(np.inf)))
    coords = np.zeros((B, L, 3), np.float32)
    for b in range(B):
        centre = rng.uniform(-4.0, 4.0, size=3).astype(np.float32)
        coords[b, 0] = centre
        for i in range(1, L):
            u = rng.normal(size=3)
            u /= np.linalg.norm(u)
            q = (centre + threshold * u).astype(np.float32)
            want = targets[rng.integers(3)]
            for _ in range(64):
                got = _sqdist_f32(q, centre)
                if got == want:
                    break
                step = np.float32(np.inf if (got < want) == (q[0] > centre[0])
                                  else -np.inf)
                q[0] = np.nextafter(q[0], step)
            coords[b, i] = q
    ins = np.zeros((B, L), bool)
    lengths = np.full(B, L, np.int32)
    return coords, ins, lengths


# Finite float32 values that round past bfloat16's largest finite value
# (3.3895e38), float32's largest among them.
FLOAT32_EXTREMES = (3.4e38, -3.4028235e38, 3.3962e38, -3.4e38)


def with_float32_extremes(xs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """A copy of (B, L, D) features with one of :data:`FLOAT32_EXTREMES` in
    each protein: row lengths[b] // 3 (a valid row), column b % D. One such
    value a protein keeps every exact aggregation sum finite."""
    out = np.array(xs, dtype=np.float32)
    for b, n in enumerate(lengths):
        out[b, int(n) // 3, b % out.shape[-1]] = FLOAT32_EXTREMES[
            b % len(FLOAT32_EXTREMES)]
    return out


def _target_chain(rng, n: int) -> np.ndarray:
    steps = rng.normal(size=(n, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
    return np.cumsum(3.8 * steps, axis=0).astype(np.float32)


def aligned_protein(rng, query_len: int, indel_rate: float = 0.08):
    """One query protein aligned to a synthetic target structure with indels.

    Walks a gapped alignment column by column: matches, query insertions
    (target gap) and deletions (query gap). Returns
    ``(sequence, proj_coords (Q, 3), ins_mask (Q,))`` through
    :func:`.ops.cmap_align.project_alignment_coords`, so unmapped query
    residues carry sentinel coordinates.
    """
    q_cols, t_cols = [], []
    t_len = 0
    q = 0
    while q < query_len:
        r = rng.random()
        if r < indel_rate / 2:            # query residue against a target gap
            q_cols.append("A")
            t_cols.append("-")
            q += 1
        elif r < indel_rate:              # target residue against a query gap
            q_cols.append("-")
            t_cols.append("A")
            t_len += 1
        else:
            q_cols.append("A")
            t_cols.append("A")
            q += 1
            t_len += 1
    seq = "".join(rng.choice(list(AMINO_ACIDS), size=query_len))
    proj, ins, qlen = project_alignment_coords(
        "".join(q_cols), "".join(t_cols), _target_chain(rng, max(t_len, 1)))
    assert qlen == query_len
    return seq, proj, ins


def aligned_items(n: int, seed: int, min_len: int = 40, max_len: int = 500):
    """``n`` engine items ``(id, seq, proj_coords, ins_mask)`` with lengths
    drawn uniformly from [min_len, max_len]."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        seq, proj, ins = aligned_protein(
            rng, int(rng.integers(min_len, max_len + 1)))
        items.append((f"p{i}", seq, proj, ins))
    return items


def threshold_head_bias(margins: np.ndarray, threshold: float, near: int,
                        seed: int) -> np.ndarray:
    """A head bias that makes scores sparse around ``threshold``.

    ``margins`` (P, n_labels) are a head's class-0 minus class-1 logits over
    a catalogue of P proteins with a zero head bias (the score is their
    sigmoid). The returned (2·n_labels,) bias moves ``near`` randomly
    chosen terms so that their median score over the catalogue sits on
    ``threshold`` (about half the proteins clear it on each), and every
    other term to 10 logits below its largest margin, so below
    sigmoid(-10) ≈ 4.5e-5 on every protein of the catalogue. The JAX
    package's top-k fetch with K ≈ near / 2 then overflows on some proteins
    and is complete on the rest.
    """
    margins = np.asarray(margins, np.float64)
    picked = np.random.default_rng(seed).choice(
        margins.shape[1], size=min(near, margins.shape[1]), replace=False)
    bias = np.zeros(2 * margins.shape[1], np.float32)
    # The class-1 bias shifts each term's margin down by its value.
    bias[1::2] = margins.max(axis=0) + 10.0
    bias[2 * picked + 1] = (np.median(margins[:, picked], axis=0)
                            - np.log(threshold / (1.0 - threshold)))
    return bias


def goterms(n: int) -> list:
    """``n`` distinct GO-term ids, ``GO:0000000`` upwards."""
    return [f"GO:{i:07d}" for i in range(n)]


def write_training_corpus(directory, n: int, terms: list, seed: int,
                          min_len: int = 40, max_len: int = 500,
                          terms_per_protein=(2, 5)):
    """A fine-tuning corpus: ``n`` CA-trace PDB files and a labels TSV.

    Each protein is a 3.8 Å random-walk chain with a length drawn uniformly
    from [min_len, max_len] and a random sequence, labelled with 2–5 (by
    default) distinct terms of ``terms``. Returns
    ``(structures_dir, labels_path)`` inside ``directory``.
    """
    directory = Path(directory)
    structures = directory / "structures"
    structures.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        length = int(rng.integers(min_len, max_len + 1))
        seq = "".join(rng.choice(list(AMINO_ACIDS), size=length))
        write_ca_pdb(structures / f"p{i}.pdb", seq,
                     _target_chain(rng, length))
        k = int(rng.integers(terms_per_protein[0], terms_per_protein[1] + 1))
        picked = rng.choice(len(terms), size=k, replace=False)
        lines.append(f"p{i}\t" + ";".join(terms[j] for j in picked))
    labels = directory / "labels.tsv"
    labels.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return structures, labels


def write_structure_db(directory, n: int, seed: int, min_len: int = 40,
                       max_len: int = 500) -> dict:
    """A structure-directory database: ``n`` CA-trace PDB files
    ``s{i}.pdb`` (3.8 Å random-walk chains, random sequences, lengths
    uniform in [min_len, max_len]) in ``directory``. Returns
    ``{id: sequence}``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    seqs = {}
    for i in range(n):
        length = int(rng.integers(min_len, max_len + 1))
        seqs[f"s{i}"] = "".join(rng.choice(list(AMINO_ACIDS), size=length))
        write_ca_pdb(directory / f"s{i}.pdb", seqs[f"s{i}"],
                     _target_chain(rng, length))
    return seqs


def hit_query(rng, seq: str, substitution_rate: float = 0.05,
              indels=(1, 2), indel_len=(1, 3)) -> str:
    """A near-copy of ``seq``: about ``substitution_rate`` of its positions
    substituted by another residue, then one or two (``indels``) short
    insertions or deletions of 1–3 residues (``indel_len``), away from the
    ends, so that the re-alignment carries insertions into the projection."""
    out = list(seq)
    n_sub = max(1, int(round(substitution_rate * len(out))))
    for pos in rng.choice(len(out), size=n_sub, replace=False):
        out[pos] = rng.choice([a for a in AMINO_ACIDS if a != out[pos]])
    for _ in range(int(rng.integers(indels[0], indels[1] + 1))):
        k = int(rng.integers(indel_len[0], indel_len[1] + 1))
        pos = int(rng.integers(5, len(out) - 5 - k))
        if rng.random() < 0.5:
            del out[pos:pos + k]
        else:
            out[pos:pos] = list(rng.choice(list(AMINO_ACIDS), size=k))
    return "".join(out)


def _gcn_model_name(config, mode: str, contact_threshold: float) -> str:
    return (f"DeepFRI-MERGED_GraphConv_"
            f"gcd_{'-'.join(map(str, config.gc_dims))}_"
            f"fcd_{'-'.join(map(str, config.fc_dims))}_ca_"
            f"{contact_threshold}_{mode}.onnx")


def _write_model_params(directory: Path, onnx_name: str, terms: list):
    with open(directory / (onnx_name[:-5] + "_model_params.json"), "w",
              encoding="utf-8") as f:
        json.dump({"goterms": list(terms),
                   "gonames": [f"term {t}" for t in terms]}, f)


def write_gcn_weights(directory, config, params: dict, terms: list,
                      mode: str = "mf", contact_threshold: float = 10.0):
    """A weights folder holding one GCN, as the published folders do.

    Writes ``params`` (a numpy or tensor tree) as ONNX with the port's
    exporter, its ``_model_params.json`` (``goterms``/``gonames``) and a
    ``model_config.json`` naming it for ``mode``. Returns the folder.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    name = _gcn_model_name(config, mode, contact_threshold)
    export_gcn_to_onnx(gcn_params_to_numpy(params), config,
                       str(directory / name))
    _write_model_params(directory, name, terms)
    with open(directory / "model_config.json", "w", encoding="utf-8") as f:
        json.dump({"gcn": {mode: name}, "cnn": {}, "version": "1.1"}, f)
    return directory


def write_model_set(directory, gcn: dict, cnn: dict,
                    contact_threshold: float = 10.0):
    """A weights folder holding a GCN and a CNN per mode, in the published
    weights' tf2onnx graph pattern (:mod:`.models.tf2onnx_fixture`).

    ``gcn`` and ``cnn`` map ``mode → (config, params, terms)``; params may
    be numpy or tensor trees. Writes each network's ONNX file, its
    ``_model_params.json`` and one ``model_config.json`` naming them all.
    The GCN graphs consume the adjacency as fed, so their configs should
    say ``adj_norm="none"`` to import back equal. Returns the folder.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    names = {"gcn": {}, "cnn": {}}
    for mode, (config, params, terms) in gcn.items():
        name = _gcn_model_name(config, mode, contact_threshold)
        export_gcn_tf2onnx_style(gcn_params_to_numpy(params), config,
                                 str(directory / name))
        _write_model_params(directory, name, terms)
        names["gcn"][mode] = name
    for mode, (config, params, terms) in cnn.items():
        name = f"DeepCNN-MERGED_{mode}.onnx"
        export_cnn_tf2onnx_style(gcn_params_to_numpy(params), config,
                                 str(directory / name))
        _write_model_params(directory, name, terms)
        names["cnn"][mode] = name
    with open(directory / "model_config.json", "w", encoding="utf-8") as f:
        json.dump({**names, "version": "1.1"}, f)
    return directory
