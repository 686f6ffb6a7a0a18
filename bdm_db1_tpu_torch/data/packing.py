"""Gato transition layout helpers (the part of bdm_db1_tpu/data/packing.py
that decode and the packed training samples read).

A transition is ``[obs_tokens(obs_len) | separator | action_tokens(act_len)]``.
``position_id`` is the local timestep id: 1..obs_len+1 over obs+separator,
0 at action slots (it feeds the RL local-timestep embedding).
"""

from __future__ import annotations

import numpy as np


def action_flags_and_position_ids(
    seq_length: int, obs_len: int, act_len: int, prepend_trans_num: int = 0
):
    """(action_flag, position_id) for a sequence that starts at a
    transition boundary; action_flag marks action tokens outside the first
    ``prepend_trans_num`` (prompt) transitions."""
    step = obs_len + act_len + 1
    idx = np.arange(seq_length, dtype=np.int64)
    within = idx % step
    position_id = np.where(within <= obs_len, 1 + within, 0).astype(np.int64)
    action_flag = (
        (within > obs_len) & (idx >= prepend_trans_num * step)
    ).astype(np.int64)
    return action_flag, position_id


def truncate_or_pad(arr: np.ndarray, length: int, pad_value=0) -> np.ndarray:
    """Cut ``arr`` to ``length`` rows or pad its tail with ``pad_value``."""
    if len(arr) > length:
        return arr[:length]
    if len(arr) < length:
        pad = np.full((length - len(arr),) + arr.shape[1:], pad_value,
                      arr.dtype)
        return np.concatenate([arr, pad], axis=0)
    return arr
