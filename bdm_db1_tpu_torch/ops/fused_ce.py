"""Masked cross-entropy over the tied LM head, blockwise over the vocab: the
forward of bdm_db1_tpu/ops/fused_ce.py (``masked_ce_tied``,
``masked_cross_entropy_fused``).

The loop runs over vocab chunks of ``_pick_block`` columns with a running
(max, sumexp) pair and the label logit, so no [N, V] f32 logits tensor is
ever held: per chunk one [N, D] x [D, block] product with f32 results, then
f32 max / exp / sum. It is XLA in the JAX package, not a Pallas kernel, so
the product goes to ``torch.mm``. The backward comes with the training
slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30
Tensor = torch.Tensor


def _pick_block(v: int, target: int = 8192) -> int:
    """Largest multiple-of-128 divisor of v that is <= target (v is a
    multiple of 128: VocabLayout.padded_vocab_size)."""
    best = v
    for b in range(128, min(target, v) + 1, 128):
        if v % b == 0:
            best = b
    return best if best <= target else v


def _chunk_logits(h2: Tensor, w_c: Tensor) -> Tensor:
    """f32 logits [N, block] of h2 [N, D] against a vocab chunk [block, D]
    cast to h2's dtype. The JAX package asks for f32 results
    (``preferred_element_type``); a bf16 ``torch.matmul`` would round them to
    bf16. On the card, ``torch.mm(..., out_dtype=torch.float32)`` keeps the
    bf16 operands on the tensor cores with f32 accumulation and an f32
    result. On the CPU the operands are widened to f32 first: bf16 values
    are exact in f32, so the products are the same exact values, summed in
    f32."""
    w_c = w_c.to(h2.dtype)
    if h2.dtype == torch.float32:
        return h2 @ w_c.t()
    if h2.is_cuda:
        return torch.mm(h2, w_c.t(), out_dtype=torch.float32)
    return h2.float() @ w_c.float().t()


def _scan_lse(h: Tensor, emb: Tensor, labels: Tensor, valid_vocab: int,
              block: int) -> Tuple[Tensor, Tensor]:
    """Blockwise (logsumexp, label logit), both [N] f32."""
    d = h.shape[-1]
    v = emb.shape[0]
    h2 = h.reshape(-1, d)
    n = h2.shape[0]
    lab = labels.reshape(-1).long()
    f32 = dict(dtype=torch.float32, device=h.device)
    m = torch.full((n,), NEG_INF, **f32)
    s = torch.zeros((n,), **f32)
    ll = torch.zeros((n,), **f32)
    cols = torch.arange(block, device=h.device)
    for c in range(v // block):
        logits = _chunk_logits(h2, emb[c * block:(c + 1) * block])
        logits = torch.where((c * block + cols)[None, :] < valid_vocab,
                             logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(-1)
        m = m_new
        local = lab - c * block
        in_chunk = (local >= 0) & (local < block)
        picked = torch.gather(logits, 1,
                              local.clamp(0, block - 1)[:, None])[:, 0]
        ll = torch.where(in_chunk, picked, ll)
    return m + torch.log(s), ll


def masked_ce_tied(h: Tensor, emb: Tensor, labels: Tensor, loss_mask: Tensor,
                   valid_vocab: int, block: int) -> Tensor:
    """Masked mean NLL of ``labels`` [B, L] under softmax(h @ emb^T) with h
    [B, L, D], emb [V, D] (``block`` divides V); the vocab tail from
    ``valid_vocab`` on is out of the softmax. Returns an f32 scalar."""
    lse, ll = _scan_lse(h, emb, labels, valid_vocab, block)
    mask = loss_mask.reshape(-1).float()
    return ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1e-8)


def masked_cross_entropy_fused(h: Tensor, emb: Tensor, labels: Tensor,
                               loss_mask: Tensor, valid_vocab: int) -> Tensor:
    """Entry point: picks the vocab block and runs :func:`masked_ce_tied`."""
    return masked_ce_tied(h, emb, labels, loss_mask, valid_vocab,
                          _pick_block(emb.shape[0]))
