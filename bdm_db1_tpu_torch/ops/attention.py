"""TransformerXL relative-attention index helpers (counterpart of
bdm_db1_tpu/ops/attention.py): the BD-term shifts and the attention masks.

Scores decompose as ``AC[b,h,i,j] = (q + r_w_bias) . k`` (content) and
``BD[b,h,i,j] = rel_shift((q + r_r_bias) . r)`` (position). Masks are bool
``[q, k]`` with True = banned.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """The TransformerXL zero-pad shift on [B, H, q, k] scores (pad one
    column on the left, fold, drop the first row, unfold)."""
    b, h, q, k = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(b, h, k + 1, q)[:, :, 1:, :]
    return x.reshape(b, h, q, k)


def rel_shift_sliced(x: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = x[i, j + q-1-i]``, zeros where that index runs past k.

    Equal to :func:`rel_shift` on every causally valid position (row i,
    columns j <= mlen + i); the trailing always-masked columns hold zeros
    instead of rel_shift's wrapped values. One padded copy, read back
    through a strided view: on the padded [.., q, k+q-1] rows the element
    (i, j + q-1-i) sits at flat offset i*(k+q-2) + j + q-1."""
    b, h, q, k = x.shape
    if q == 1:
        return x
    xp = F.pad(x, (0, q - 1)).contiguous()
    s0, s1 = xp.stride(0), xp.stride(1)
    return xp.as_strided((b, h, q, k), (s0, s1, k + q - 2, 1),
                         xp.storage_offset() + q - 1)


def causal_mask(qlen: int, klen: int, device="cpu") -> torch.Tensor:
    """[q, k] bool mask, True = banned: plain causal with a memory prefix."""
    mlen = klen - qlen
    i = torch.arange(qlen, device=device)[:, None]
    j = torch.arange(klen, device=device)[None, :]
    return j > i + mlen


def same_length_mask(qlen: int, klen: int, mem_len: int,
                     device="cpu") -> torch.Tensor:
    """Sliding-window mask: each query sees exactly ``mem_len`` keys."""
    mlen = klen - qlen
    i = torch.arange(qlen, device=device)[:, None]
    j = torch.arange(klen, device=device)[None, :]
    upper = j > i + mlen
    mask_len = klen - mem_len
    mask_shift_len = qlen - mask_len if mask_len > 0 else qlen
    lower = j < i - (mask_shift_len - 1)
    return upper | lower
