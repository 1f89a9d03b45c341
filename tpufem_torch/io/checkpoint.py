"""Checkpoint/resume for solution state (npz-based).

The reference study has no checkpointing -- its runs always go from start
to finish; the closest artifact is its binary displacement dump. A long
Newton run on a large case saves its state here after every step and
resumes from it. Pure NumPy: tensors are handed over as host arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Save a flat dict of arrays/scalars to a .npz file (NumPy appends
    ``.npz`` to a ``path`` without it)."""
    flat = {}
    for k, v in state.items():
        flat[k] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
