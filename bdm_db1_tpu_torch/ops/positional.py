"""Sinusoidal relative positional embeddings (TransformerXL style), the
counterpart of bdm_db1_tpu/ops/positional.py.

``inv_freq = 1/10000^(2i/d)`` over a descending position sequence
``[klen-1, ..., 0]`` clamped at ``clamp_len``; the embedding is
``concat(sin, cos)`` along the feature axis.
"""

from __future__ import annotations

import torch


def relative_positional_embedding(klen: int, d_model: int, clamp_len: int,
                                  dtype=torch.float32,
                                  device="cpu") -> torch.Tensor:
    """Returns [klen, d_model]; row 0 is the most distant position."""
    inv_freq = 1.0 / (10000.0 ** (
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        / d_model))
    pos_seq = torch.arange(klen - 1, -1, -1, dtype=torch.float32,
                           device=device)
    if clamp_len > 0:
        pos_seq = pos_seq.clamp(max=float(clamp_len))
    sinusoid = pos_seq[:, None] * inv_freq[None, :]
    emb = torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], dim=-1)
    return emb.to(dtype)
