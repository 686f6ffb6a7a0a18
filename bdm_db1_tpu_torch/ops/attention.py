"""TransformerXL relative attention, plain PyTorch (counterpart of
bdm_db1_tpu/ops/attention.py): the BD-term shifts, the attention masks and
``rel_attention``, the plain route of the full-sequence trunk.

Scores decompose as ``AC[b,h,i,j] = (q + r_w_bias) . k`` (content) and
``BD[b,h,i,j] = rel_shift((q + r_r_bias) . r)`` (position). Masks are bool
``[q, k]`` with True = banned.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bdm_db1_tpu_torch.ops.fast_dropout import sharded_draw

MASK_VALUE = -1e30


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


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  r: torch.Tensor, r_w_bias: torch.Tensor,
                  r_r_bias: torch.Tensor, mask: Optional[torch.Tensor], *,
                  scale: Optional[float] = None,
                  compute_dtype=torch.bfloat16, dropout_rate: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  dropout_shard=None) -> torch.Tensor:
    """q [B, qlen, H, Dh], k/v [B, klen, H, Dh], r [klen, H, Dh] projected
    positional embeddings (row 0 the most distant), biases [H, Dh], mask
    [q, k] or [B, q, k] bool (True = banned) -> [B, qlen, H, Dh] in
    ``compute_dtype``. Scores, mask and softmax in f32; with a
    ``dropout_rate`` the f32 probabilities keep each entry with probability
    1 - rate (a Bernoulli draw from ``generator``) and are divided by
    1 - rate; then they are cast to the compute dtype for the PV
    product. ``dropout_shard`` (ops/fast_dropout.py ``Shard``): the heads
    are a slice of a model's (a rank of a tensor-parallel group), and the
    draw is the whole model's, narrowed to them."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    qf = q.float()
    rw_q = qf + r_w_bias.float()
    rr_q = qf + r_r_bias.float()
    ac = torch.einsum("bihd,bjhd->bhij", rw_q, k.float())
    bd = rel_shift(torch.einsum("bihd,jhd->bhij", rr_q, r.float()))
    scores = (ac + bd) * scale
    if mask is not None:
        mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
        scores = torch.where(mask, MASK_VALUE, scores)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("attention dropout draws from an explicit "
                             "torch.Generator; none was given")
        keep = sharded_draw(probs, dropout_shard, lambda shape: torch.rand(
            shape, generator=generator, device=probs.device)
        ) < 1.0 - dropout_rate
        probs = probs * keep / (1.0 - dropout_rate)
    probs = probs.to(compute_dtype)
    return torch.einsum("bhij,bjhd->bihd", probs, v.to(compute_dtype))
