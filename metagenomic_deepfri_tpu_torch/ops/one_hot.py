"""Sequence tokenisation (host, numpy) and one-hot expansion (torch).

Counterpart of ``metagenomic_deepfri_tpu/ops/one_hot.py``. The 26-character
vocabulary order is the bit-compatibility contract with the DeepFRI weights
and must not change.
"""

from __future__ import annotations

import numpy as np
import torch

# Exact DeepFRI vocabulary (same order as the JAX package).
ALPHABET = "-DGULNTKHYWCPVSOIEFXQABZRM"
VOCAB_SIZE = len(ALPHABET)  # 26

# 256-entry ASCII → token lookup; -1 marks invalid characters.
_CHAR_MAP = np.full(256, -1, dtype=np.int16)
for _i, _c in enumerate(ALPHABET):
    _CHAR_MAP[ord(_c)] = _i

# Token used to fill padded positions; always masked out downstream.
PAD_TOKEN = 0


def seq2tokens(seq: str) -> np.ndarray:
    """Tokenise a protein sequence into uint8 codes over :data:`ALPHABET`.

    Raises ``ValueError`` on characters outside the vocabulary.
    """
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    tokens = _CHAR_MAP[raw]
    bad = np.nonzero(tokens < 0)[0]
    if bad.size:
        raise ValueError(f"Invalid character in sequence: {seq[int(bad[0])]}")
    return tokens.astype(np.uint8)


def seq2onehot(seq: str) -> np.ndarray:
    """(L, 26) float32 one-hot of a sequence, on the host."""
    tokens = seq2tokens(seq)
    onehot = np.zeros((tokens.shape[0], VOCAB_SIZE), dtype=np.float32)
    onehot[np.arange(tokens.shape[0]), tokens] = 1.0
    return onehot


def tokens2onehot(tokens: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One-hot expansion of a (…, L) uint8/int token tensor → (…, L, 26)."""
    vocab = torch.arange(VOCAB_SIZE, dtype=torch.int64, device=tokens.device)
    return (tokens.to(torch.int64).unsqueeze(-1) == vocab).to(dtype)


def batch_tokens(seqs: list[str], pad_to: int) -> tuple[np.ndarray, np.ndarray]:
    """Tokenise and right-pad a list of sequences to a fixed length.

    Returns ``(tokens (B, pad_to) uint8, lengths (B,) int32)`` on the host.
    The padded region holds :data:`PAD_TOKEN` and must be masked downstream.
    """
    batch = np.full((len(seqs), pad_to), PAD_TOKEN, dtype=np.uint8)
    lengths = np.zeros(len(seqs), dtype=np.int32)
    for i, seq in enumerate(seqs):
        tokens = seq2tokens(seq)
        if tokens.shape[0] > pad_to:
            raise ValueError(
                f"Sequence length {tokens.shape[0]} exceeds pad_to={pad_to}")
        batch[i, : tokens.shape[0]] = tokens
        lengths[i] = tokens.shape[0]
    return batch, lengths
