"""Checkpoints (counterpart of ``efficient_gnns_tpu/train/checkpoint.py``).

The port's format is ``torch.save`` of a dict of ``state_dict``s and plain
numbers: it needs nothing beyond torch. The optimizer's per-parameter state
(Adam's ``step`` / ``exp_avg`` / ``exp_avg_sq``) is keyed by
``<module>.<parameter>`` rather than by the optimizer's parameter order, so
a file names what it holds and a converter can write one without building
the modules. The JAX package writes flax msgpack instead; the port does not
read it (flax imports JAX).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch


def save_checkpoint(path: str, obj: Any) -> str:
    """``torch.save(obj, path)``, creating the file's directory; returns
    ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(obj, path)
    return path


def load_checkpoint(path: str, map_location=None) -> Any:
    """What :func:`save_checkpoint` wrote, tensors placed by ``map_location``
    (``torch.load`` with ``weights_only=True``: no code is unpickled)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def _named_parameters(modules: Mapping[str, torch.nn.Module]):
    for key, module in modules.items():
        for name, p in module.named_parameters():
            yield f"{key}.{name}", p


def optimizer_moments(modules: Mapping[str, torch.nn.Module],
                      optimizer: torch.optim.Optimizer) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optimizer's state of every parameter of ``modules`` that has one,
    keyed by ``<module key>.<parameter name>``."""
    return {name: dict(optimizer.state[p]) for name, p in _named_parameters(modules)
            if p in optimizer.state}


def load_optimizer_moments(modules: Mapping[str, torch.nn.Module],
                           optimizer: torch.optim.Optimizer,
                           moments: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
    """Set the state that :func:`optimizer_moments` returned: each moment on
    its parameter's device and dtype, ``step`` left where it lies (a CPU
    scalar, as torch's Adam keeps it)."""
    for name, p in _named_parameters(modules):
        if name in moments:
            optimizer.state[p] = {k: v if k == "step" else v.to(p.device, p.dtype)
                                  for k, v in moments[name].items()}
