"""Activations of the decoder's feed-forward block (counterpart of
bdm_db1_tpu/models/activations.py).

``gelu`` is the exact erf form; ``geglu`` halves the feature dim:
``a * gelu(b)`` with ``a, b`` the two halves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def geglu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * gelu(b)


ACT2FN = {
    "gelu": gelu,
    "gelu_new": gelu_new,
    "geglu": geglu,
    "relu": F.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
}
