"""Parameter trees between numpy (the JAX package's form) and torch.

A JAX GCN or CNN tree — nested dicts and lists of arrays from ``init_gcn``,
``init_cnn`` or the ONNX importers — has the layouts the port keeps (dense
kernels (in, out) for ``x @ kernel``; LSTM ``kernel`` (in, 4H),
``recurrent`` (H, 4H), gates ``[i, f, c, o]``; conv kernels (width, in, out),
which the CNN forward permutes for ``conv1d``), so conversion is a plain copy
of each leaf, with no transposes or reordering.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from metagenomic_deepfri_tpu_torch.models.esm2 import ESM2Config
from metagenomic_deepfri_tpu_torch.models.esmc import ESMCConfig
from metagenomic_deepfri_tpu_torch.models.prott5 import ProtT5Config


def gcn_params_from_numpy(tree, device,
                          dtype: torch.dtype = torch.float32,
                          requires_grad: bool = False):
    """Copy every array leaf of ``tree`` to a ``dtype`` tensor on ``device``.

    Leaves may be numpy arrays, anything ``np.asarray`` accepts, or tensors
    (moved, not copied, when already of that device and dtype). With
    ``requires_grad`` every leaf is a fresh copy that autograd tracks: the
    trainable parameters of a fine-tuning run, which the optimizer updates
    in place without touching ``tree``.
    """
    if isinstance(tree, dict):
        return {k: gcn_params_from_numpy(v, device, dtype, requires_grad)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gcn_params_from_numpy(v, device, dtype, requires_grad)
                for v in tree]
    if isinstance(tree, torch.Tensor):
        leaf = tree.detach().to(device=device, dtype=dtype,
                                copy=requires_grad)
    else:
        leaf = torch.tensor(np.asarray(tree), dtype=dtype, device=device)
    return leaf.requires_grad_(requires_grad)


def gcn_params_to_numpy(tree):
    """Inverse of :func:`gcn_params_from_numpy`: float32 numpy leaves
    (numpy leaves pass through as float32)."""
    if isinstance(tree, dict):
        return {k: gcn_params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gcn_params_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", torch.float32).numpy()
    return np.asarray(tree, np.float32)


# The CNN tree converts leaf by leaf exactly as the GCN tree does.
cnn_params_from_numpy = gcn_params_from_numpy
cnn_params_to_numpy = gcn_params_to_numpy


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu", torch.float32)
    return np.asarray(value, np.float32)


def esm2_from_hf_state_dict(state: Mapping, heads: int) -> tuple:
    """``(ESM2Config, trunk tree)`` of an ESM-2 state dict in the Hugging
    Face key layout (``[esm.]embeddings.word_embeddings.weight``,
    ``[esm.]encoder.layer.{i}.attention.self.query.weight``, …,
    ``[esm.]encoder.emb_layer_norm_after.*``), as :mod:`.esm2` lays the
    trunk out: ``nn.Linear`` weights (out, in) transposed to kernels (in,
    out), query, key and value side by side in one ``qkv`` kernel,
    ``attention.LayerNorm`` as LN₁ and the layer's ``LayerNorm`` as LN₂.
    Leaves are float32 numpy arrays. The layer count and widths come from
    the shapes, ``heads`` (which no shape gives) from the argument, the
    rotary base and LayerNorm epsilon are ESM-2's. Heads other than the
    encoder's (the masked-LM and contact heads, the pooler) are not
    read."""
    def get(name):
        for key in ("esm." + name, name):
            if key in state:
                return _host(state[key])
        raise KeyError(f"no {name!r} in the ESM-2 state dict")

    def dense(name):
        return {"kernel": get(name + ".weight").T.copy(),
                "bias": get(name + ".bias")}

    def norm(name):
        return {"scale": get(name + ".weight"), "bias": get(name + ".bias")}

    n_layers = 1 + max(int(m.group(1)) for m in (
        re.search(r"encoder\.layer\.(\d+)\.", k) for k in state) if m)
    layers = []
    for i in range(n_layers):
        a = f"encoder.layer.{i}.attention."
        q, k, v = (dense(a + "self." + n) for n in ("query", "key", "value"))
        layers.append({
            "ln1": norm(a + "LayerNorm"),
            "qkv": {"kernel": np.concatenate(
                        [q["kernel"], k["kernel"], v["kernel"]], axis=1),
                    "bias": np.concatenate([q["bias"], k["bias"],
                                            v["bias"]])},
            "out": dense(a + "output.dense"),
            "ln2": norm(f"encoder.layer.{i}.LayerNorm"),
            "fc1": dense(f"encoder.layer.{i}.intermediate.dense"),
            "fc2": dense(f"encoder.layer.{i}.output.dense")})
    tree = {"embed": get("embeddings.word_embeddings.weight"),
            "layers": layers,
            "ln_after": norm("encoder.emb_layer_norm_after")}
    vocab, dim = tree["embed"].shape
    cfg = ESM2Config(layers=n_layers, dim=dim, heads=heads,
                     ffn=layers[0]["fc1"]["kernel"].shape[1], vocab=vocab)
    return cfg, tree


def prott5_from_hf_state_dict(state: Mapping, heads: int,
                              max_distance: int = 128,
                              eps: float = 1e-6) -> tuple:
    """``(ProtT5Config, encoder tree)`` of a T5 encoder state dict in the
    ``T5EncoderModel`` key layout (``shared.weight``,
    ``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}.weight``, the
    ``relative_attention_bias.weight`` of block 0,
    ``layer.0.layer_norm``, ``layer.1.DenseReluDense.{wi,wo}``,
    ``layer.1.layer_norm``, ``encoder.final_layer_norm``), as
    :mod:`.prott5` lays the trunk out: ``nn.Linear`` weights (out, in)
    transposed to kernels (in, out), q, k and v side by side in one ``qkv``
    kernel. Leaves are float32 numpy arrays. The layer count, widths,
    bucket count and vocabulary come from the shapes; ``heads`` (which fixes
    d_kv), the bucket's ``max_distance`` and the RMS ``eps`` from the
    arguments (T5's defaults). A decoder's keys, if present, are not
    read."""
    def get(name):
        if name not in state:
            raise KeyError(f"no {name!r} in the T5 encoder state dict")
        return _host(state[name])

    def kernel(name):
        return get(name + ".weight").T.copy()

    n_layers = 1 + max(int(m.group(1)) for m in (
        re.match(r"encoder\.block\.(\d+)\.", k) for k in state) if m)
    layers = []
    for i in range(n_layers):
        b = f"encoder.block.{i}.layer."
        a = b + "0.SelfAttention."
        layers.append({
            "ln1": {"scale": get(b + "0.layer_norm.weight")},
            "qkv": {"kernel": np.concatenate(
                [kernel(a + n) for n in ("q", "k", "v")], axis=1)},
            "o": {"kernel": kernel(a + "o")},
            "ln2": {"scale": get(b + "1.layer_norm.weight")},
            "wi": {"kernel": kernel(b + "1.DenseReluDense.wi")},
            "wo": {"kernel": kernel(b + "1.DenseReluDense.wo")}})
    tree = {"embed": get("shared.weight"),
            "rel_bias": get("encoder.block.0.layer.0.SelfAttention."
                            "relative_attention_bias.weight"),
            "layers": layers,
            "ln_final": {"scale": get("encoder.final_layer_norm.weight")}}
    vocab, dim = tree["embed"].shape
    inner = layers[0]["o"]["kernel"].shape[0]
    cfg = ProtT5Config(layers=n_layers, dim=dim, heads=heads,
                       d_kv=inner // heads,
                       ffn=layers[0]["wi"]["kernel"].shape[1],
                       buckets=tree["rel_bias"].shape[0],
                       max_distance=max_distance, eps=eps, vocab=vocab)
    return cfg, tree


def esmc_from_state_dict(state: Mapping, heads: int | None = None) -> tuple:
    """``(ESMCConfig, trunk tree)`` of an ESM C state dict in the ``esm``
    package's key layout (``embed.weight``,
    ``transformer.blocks.{i}.attn.layernorm_qkv.{0,1}.*``,
    ``.attn.q_ln.weight``, ``.attn.k_ln.weight``, ``.attn.out_proj.weight``,
    ``.ffn.{0,1,3}.*``, ``transformer.norm.weight``), as :mod:`.esmc` lays
    the trunk out: ``nn.Linear`` weights (out, in) transposed to kernels
    (in, out), ``layernorm_qkv.1`` as the ``[q | k | v]`` kernel and
    ``ffn.1`` as the ``[gate | up]`` kernel, each kept in its order. Leaves
    are float32 numpy arrays. The layer count and widths come from the
    shapes; ``heads`` from the argument, else d / 64 (ESM C's heads are 64
    wide); the rotary base and LayerNorm epsilon are ESM C's. The
    ``sequence_head`` is not read."""
    def get(name):
        if name not in state:
            raise KeyError(f"no {name!r} in the ESM C state dict")
        return _host(state[name])

    def kernel(name):
        return {"kernel": get(name + ".weight").T.copy()}

    def norm(name, shift=True):
        p = {"scale": get(name + ".weight")}
        if shift:
            p["bias"] = get(name + ".bias")
        return p

    n_layers = 1 + max(int(m.group(1)) for m in (
        re.match(r"transformer\.blocks\.(\d+)\.", k) for k in state) if m)
    layers = []
    for i in range(n_layers):
        b = f"transformer.blocks.{i}."
        layers.append({
            "ln_qkv": norm(b + "attn.layernorm_qkv.0"),
            "qkv": kernel(b + "attn.layernorm_qkv.1"),
            "q_ln": norm(b + "attn.q_ln", shift=False),
            "k_ln": norm(b + "attn.k_ln", shift=False),
            "out": kernel(b + "attn.out_proj"),
            "ln_ffn": norm(b + "ffn.0"),
            "fc1": kernel(b + "ffn.1"),
            "fc2": kernel(b + "ffn.3")})
    tree = {"embed": get("embed.weight"), "layers": layers,
            "ln_final": norm("transformer.norm", shift=False)}
    vocab, dim = tree["embed"].shape
    cfg = ESMCConfig(layers=n_layers, dim=dim,
                     heads=heads if heads is not None else dim // 64,
                     ffn=layers[0]["fc2"]["kernel"].shape[0], vocab=vocab)
    return cfg, tree
