"""The explicit device and dtype every part of the port is handed.

`resolve_device` reads TORCH_DEVICE (default "cuda") and raises when CUDA is
asked for and absent: the port never quietly serves on the CPU. Float32
matrix products and convolutions are pinned to full IEEE f32 (no TF32),
because the f32 parity claims against the JAX package rest on it.
"""

from __future__ import annotations

import os

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(name: str | None = None) -> torch.device:
    """`name` (or TORCH_DEVICE, default "cuda") as a torch.device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(name or os.environ.get("TORCH_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or TORCH_DEVICE=cpu) to run the plain "
            "PyTorch versions on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Settings.dtype string ("bfloat16" | "float32") → torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported COMPUTE_DTYPE {name!r}; "
                         f"expected one of {sorted(_DTYPES)}") from None
