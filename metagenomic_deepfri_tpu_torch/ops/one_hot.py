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


def tokens2onehot(tokens: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One-hot expansion of a (…, L) uint8/int token tensor → (…, L, 26)."""
    vocab = torch.arange(VOCAB_SIZE, dtype=torch.int64, device=tokens.device)
    return (tokens.to(torch.int64).unsqueeze(-1) == vocab).to(dtype)
