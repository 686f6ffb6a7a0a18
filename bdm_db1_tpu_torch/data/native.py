"""Dataset index helpers (the RL sample index of bdm_db1_tpu/data/native.py,
as its numpy form).

The JAX package builds the same index in C++ when its helper library
compiles and in numpy otherwise; both give one row per timestep, so a
trajectory of length n yields n samples (the original reference yields
n - 1). The port matches the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def build_rl_sample_idx(path_lengths: Sequence[int],
                        transition_num: int) -> np.ndarray:
    """[sum(lengths), 3] int64 rows (path, start, end) with
    end = min(start + transition_num, length), one per timestep."""
    lengths = np.asarray(path_lengths, dtype=np.int64)
    out = np.empty((int(lengths.sum()), 3), dtype=np.int64)
    row = 0
    for p, n in enumerate(lengths):
        n = int(n)
        starts = np.arange(n, dtype=np.int64)
        out[row: row + n, 0] = p
        out[row: row + n, 1] = starts
        out[row: row + n, 2] = np.minimum(starts + transition_num, n)
        row += n
    return out
