"""LSTM layers for the DeepFRI language-model branch, in PyTorch.

Counterpart of ``metagenomic_deepfri_tpu/models/lstm.py``. Parameters keep
the JAX layout: ``kernel`` (in, 4H), ``recurrent`` (H, 4H), ``bias`` (4H,),
gates ordered Keras/ONNX ``[i, f, c, o]`` — the same order as PyTorch's
``[i, f, g, o]``.

The recurrence is an explicit step loop that reproduces the reference's
precision split (``lstm.py:56-77``): the input projection is one matmul of
``compute_dtype`` operands with a float32 result, plus the bias; the carried
hidden state is in ``compute_dtype`` and the cell state in float32; the
emitted per-step output is the float32 ``h`` before the cast, so the next
layer and the embedding see float32. cuDNN's ``nn.LSTM`` keeps no such
split and is not used. With float64 compute everything is float64: that
mode exists to check float32 training against a higher precision. The loop
is differentiable (training backpropagates through it with autograd).
"""

from __future__ import annotations

import math

import torch


def _uniform(shape, scale: float, generator: torch.Generator,
             device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return ((u * 2.0 - 1.0) * scale).to(device)


def init_lstm(in_dim: int, hidden: int, generator: torch.Generator,
              device) -> dict:
    """Glorot-uniform kernel and recurrent weights, unit forget-gate bias."""
    scale = math.sqrt(6.0 / (in_dim + 4 * hidden))
    rscale = math.sqrt(6.0 / (hidden + 4 * hidden))
    bias = torch.zeros(4 * hidden, dtype=torch.float32, device=device)
    bias[hidden:2 * hidden] = 1.0
    return {"kernel": _uniform((in_dim, 4 * hidden), scale, generator, device),
            "recurrent": _uniform((hidden, 4 * hidden), rscale, generator,
                                  device),
            "bias": bias}


def init_lstm_stack(in_dim: int, hidden: int, layers: int,
                    generator: torch.Generator, device,
                    bidirectional: bool = False) -> list:
    params = []
    layer_out = hidden * (2 if bidirectional else 1)
    for i in range(layers):
        d = in_dim if i == 0 else layer_out
        if bidirectional:
            params.append({"fwd": init_lstm(d, hidden, generator, device),
                           "bwd": init_lstm(d, hidden, generator, device)})
        else:
            params.append(init_lstm(d, hidden, generator, device))
    return params


def accumulate_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """The type sums and the cell state are kept in: float32 for bfloat16
    and float32 compute, float64 for float64 (the reference precision)."""
    return torch.promote_types(compute_dtype, torch.float32)


def _matmul_f32_result(a: torch.Tensor, b: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``dtype``, float32 result
    (float64 for float64 operands).

    Products of bfloat16 values are exact in float32, so a float32 matmul of
    the rounded operands is the bf16-in, f32-accumulate product of the
    reference (``preferred_element_type=float32``).
    """
    acc = accumulate_dtype(dtype)
    return a.to(dtype).to(acc) @ b.to(dtype).to(acc)


def lstm_forward(params: dict, x: torch.Tensor, reverse: bool = False,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Run an LSTM over the length axis of ``x`` (B, L, D) → (B, L, H) f32.

    ``reverse=True`` scans right-to-left. Padded positions are processed like
    any other step; forward-direction outputs at valid positions are
    unaffected by right padding. The per-step outputs are collected and
    stacked once, so autograd records one stack rather than a chain of
    in-place slice writes.
    """
    acc = accumulate_dtype(compute_dtype)
    hidden = params["recurrent"].shape[0]
    B, L = x.shape[0], x.shape[1]
    if L == 0:
        return torch.zeros((B, 0, hidden), dtype=acc, device=x.device)
    xw = _matmul_f32_result(x, params["kernel"], compute_dtype) \
        + params["bias"].to(acc)
    recurrent = params["recurrent"].to(compute_dtype)
    h = torch.zeros((B, hidden), dtype=compute_dtype, device=x.device)
    c = torch.zeros((B, hidden), dtype=acc, device=x.device)
    out = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        gates = xw[:, t] + (h @ recurrent).to(acc)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_out = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h_out
        h = h_out.to(compute_dtype)
    return torch.stack(out, dim=1)


def reverse_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Flip each row of a right-padded (B, L, D) batch within its length;
    positions beyond the length stay in place."""
    L = x.shape[1]
    pos = torch.arange(L, dtype=torch.int64, device=x.device)[None, :]
    n = lengths.to(torch.int64)[:, None]
    idx = torch.where(pos < n, n - 1 - pos, pos)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def lstm_bidirectional_forward(params: dict, x: torch.Tensor,
                               lengths: torch.Tensor,
                               compute_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """Bidirectional layer {'fwd', 'bwd'} → (B, L, 2H), [forward ‖ backward].

    The backward direction runs a forward scan over the length-aware
    reversed input, and its outputs are reversed back.
    """
    fwd = lstm_forward(params["fwd"], x, compute_dtype=compute_dtype)
    bwd = reverse_sequences(
        lstm_forward(params["bwd"], reverse_sequences(x, lengths),
                     compute_dtype=compute_dtype), lengths)
    return torch.cat([fwd, bwd], dim=-1)


def lstm_stack_forward(params: list, x: torch.Tensor,
                       lengths: torch.Tensor | None = None,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Run a stack of unidirectional or {'fwd','bwd'} bidirectional layers
    (the latter require ``lengths``)."""
    for layer in params:
        if "fwd" in layer:
            if lengths is None:
                raise ValueError(
                    "bidirectional LSTM layers require sequence lengths")
            x = lstm_bidirectional_forward(layer, x, lengths,
                                           compute_dtype=compute_dtype)
        else:
            x = lstm_forward(layer, x, compute_dtype=compute_dtype)
    return x
