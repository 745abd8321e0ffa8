"""Float32 matmul precision, set explicitly.

The JAX engine forces "highest" matmul precision whenever every loaded model
computes in float32 (``metagenomic_deepfri_tpu/batching/engine.py:403-415``):
"float32" must mean float32, not TF32. PyTorch on a GPU runs float32 matmuls
in full precision by default but float32 convolutions through cuDNN in TF32,
and either default can be changed by other code in the process, so the port
states both settings instead of relying on them.
"""

from __future__ import annotations

import contextlib

import torch


def use_highest_f32_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN; full-precision float32 matmuls.

    These are process-wide PyTorch settings.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def highest_f32_precision_active() -> bool:
    """True when float32 matmuls and convolutions run without TF32."""
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


@contextlib.contextmanager
def highest_f32_precision():
    """:func:`use_highest_f32_precision` inside the block; the previous
    settings come back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    use_highest_f32_precision()
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
