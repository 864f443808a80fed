"""Message dtype of the sparse aggregation (counterpart of
``efficient_gnns_tpu/ops/dispatch.py``).

``message_dtype``: dtype in which gathered edge messages are read by the
SpMM kernel. ``torch.bfloat16`` halves the gathered bytes; accumulation is
float32 either way. The JAX backend switch has no counterpart: the device of
the tensors decides (CUDA kernel on the card, plain PyTorch on the CPU).
"""

from __future__ import annotations

import torch

_MESSAGE_DTYPES = (torch.float32, torch.bfloat16)
_state = {"message_dtype": torch.float32}


def set_message_dtype(dtype: torch.dtype) -> None:
    if dtype not in _MESSAGE_DTYPES:
        raise ValueError(f"message dtype must be one of {_MESSAGE_DTYPES}, got {dtype}")
    _state["message_dtype"] = dtype


def message_dtype() -> torch.dtype:
    return _state["message_dtype"]
