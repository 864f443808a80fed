"""Teacher artifact I/O (counterpart of ``efficient_gnns_tpu/distill/artifacts.py``),
in the same ``.npz`` format, so each package reads the other's dumps:

    <dir>/teacher_seed<k>.npz  with arrays:
        features : float32 [N, D]   penultimate-layer activations
        logits   : float32 [N, C]   raw logits
        output   : float32 [N, C]   softmax probabilities (optional)
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def teacher_dump_path(dir_: str, seed: int) -> str:
    return os.path.join(dir_, f"teacher_seed{seed}.npz")


def save_teacher_dump(
    dir_: str,
    seed: int,
    features: np.ndarray,
    logits: np.ndarray,
    output: Optional[np.ndarray] = None,
) -> str:
    """Write one seed's dump; returns its path."""
    os.makedirs(dir_, exist_ok=True)
    path = teacher_dump_path(dir_, seed)
    arrays = {
        "features": np.asarray(features, np.float32),
        "logits": np.asarray(logits, np.float32),
    }
    if output is not None:
        arrays["output"] = np.asarray(output, np.float32)
    np.savez(path, **arrays)
    return path


def load_teacher_dump(dir_: str, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (features, logits) for one seed."""
    with np.load(teacher_dump_path(dir_, seed)) as z:
        return z["features"], z["logits"]
