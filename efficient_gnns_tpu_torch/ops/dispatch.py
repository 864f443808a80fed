"""Message dtypes of the sparse aggregation (counterpart of
``efficient_gnns_tpu/ops/dispatch.py``).

``message_dtype``: dtype in which gathered edge messages are read by the
SpMM kernel. ``torch.bfloat16`` halves the gathered bytes; accumulation is
float32 either way.
``hub_message_dtype``: message dtype of the hub attention path
(``ops/hub_attention.py``); bfloat16 by default, as in the JAX package,
with float32 accumulation. Exactness tests pin it to float32.

The JAX backend switch has no counterpart: the device of the tensors decides
(CUDA kernel on the card, plain PyTorch on the CPU).
"""

from __future__ import annotations

import torch

_MESSAGE_DTYPES = (torch.float32, torch.bfloat16)
_state = {"message_dtype": torch.float32, "hub_message_dtype": torch.bfloat16}


def _check(dtype: torch.dtype) -> None:
    if dtype not in _MESSAGE_DTYPES:
        raise ValueError(f"message dtype must be one of {_MESSAGE_DTYPES}, got {dtype}")


def set_message_dtype(dtype: torch.dtype) -> None:
    _check(dtype)
    _state["message_dtype"] = dtype


def message_dtype() -> torch.dtype:
    return _state["message_dtype"]


def set_hub_message_dtype(dtype: torch.dtype) -> None:
    _check(dtype)
    _state["hub_message_dtype"] = dtype


def hub_message_dtype() -> torch.dtype:
    return _state["hub_message_dtype"]
