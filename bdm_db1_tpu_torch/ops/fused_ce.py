"""Masked cross-entropy over the tied LM head, blockwise over the vocab
(bdm_db1_tpu/ops/fused_ce.py: ``masked_ce_tied`` with its custom VJP,
``masked_cross_entropy_fused``).

Forward: the loop runs over vocab chunks of ``_pick_block`` columns with a
running (max, sumexp) pair and the label logit, so no [N, V] f32 logits
tensor is ever held: per chunk one [N, D] x [D, block] product with f32
results, then f32 max / exp / sum. Backward (a ``torch.autograd.Function``
saving h, the embedding, labels, mask, the [N] logsumexp and the
denominator): per chunk it recomputes the f32 logits, forms
dl = (softmax - onehot) * g * mask / denom, rounds dl to h's dtype and
emits dh += dl @ W_c and dW_c = dl^T @ h with f32 results. It is XLA in the
JAX package, not a Pallas kernel, so the products go to ``torch.mm``.
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


def _mm_f32(a: Tensor, b: Tensor) -> Tensor:
    """a @ b with f32 results for operands of one dtype. The JAX package
    asks for f32 results (``preferred_element_type``); a bf16
    ``torch.matmul`` would round them to bf16. On the card,
    ``torch.mm(..., out_dtype=torch.float32)`` keeps the bf16 operands on
    the tensor cores with f32 accumulation and an f32 result. On the CPU the
    operands are widened to f32 first: bf16 values are exact in f32, so the
    products are the same exact values, summed in f32."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_logits(h2: Tensor, w_c: Tensor) -> Tensor:
    """f32 logits [N, block] of h2 [N, D] against a vocab chunk [block, D]
    cast to h2's dtype."""
    return _mm_f32(h2, w_c.to(h2.dtype).t())


def _masked_chunk_logits(h2: Tensor, w_c: Tensor, c: int, block: int,
                         valid_vocab: int) -> Tensor:
    """Chunk c's f32 logits with the vocab tail from ``valid_vocab`` on at
    NEG_INF."""
    cols = torch.arange(block, device=h2.device)
    return torch.where((c * block + cols)[None, :] < valid_vocab,
                       _chunk_logits(h2, w_c), NEG_INF)


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
    for c in range(v // block):
        logits = _masked_chunk_logits(h2, emb[c * block:(c + 1) * block], c,
                                      block, valid_vocab)
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


class _MaskedCETied(torch.autograd.Function):
    """The custom VJP of the JAX ``masked_ce_tied``: the forward keeps only
    the [N] logsumexp beside its inputs; the backward recomputes each
    chunk's logits. Gradients reach h and the embedding."""

    @staticmethod
    def forward(ctx, h, emb, labels, loss_mask, valid_vocab, block):
        lse, ll = _scan_lse(h, emb, labels, valid_vocab, block)
        mask = loss_mask.reshape(-1).float()
        denom = torch.clamp(mask.sum(), min=1e-8)
        ctx.save_for_backward(h, emb, labels, loss_mask, lse, denom)
        ctx.valid_vocab, ctx.block = valid_vocab, block
        return ((lse - ll) * mask).sum() / denom

    @staticmethod
    def backward(ctx, g):
        h, emb, labels, loss_mask, lse, denom = ctx.saved_tensors
        block = ctx.block
        d = h.shape[-1]
        h2 = h.reshape(-1, d)
        lab = labels.reshape(-1).long()
        scale = g * loss_mask.reshape(-1).float() / denom      # [N] f32
        cols = torch.arange(block, device=h.device)
        dh = torch.zeros(h2.shape, dtype=torch.float32, device=h.device)
        dws = []
        for c in range(emb.shape[0] // block):
            w_c = emb[c * block:(c + 1) * block].to(h2.dtype)
            logits = _masked_chunk_logits(h2, w_c, c, block, ctx.valid_vocab)
            onehot = (lab - c * block)[:, None] == cols[None, :]
            dl = (torch.exp(logits - lse[:, None]) - onehot.float()) \
                * scale[:, None]
            dl16 = dl.to(h2.dtype)
            dh += _mm_f32(dl16, w_c)
            dws.append(_mm_f32(dl16.t(), h2))
        dw = torch.cat(dws).to(emb.dtype)
        return dh.to(h.dtype).reshape(h.shape), dw, None, None, None, None


def masked_ce_tied(h: Tensor, emb: Tensor, labels: Tensor, loss_mask: Tensor,
                   valid_vocab: int, block: int) -> Tensor:
    """Masked mean NLL of ``labels`` [B, L] under softmax(h @ emb^T) with h
    [B, L, D], emb [V, D] (``block`` divides V); the vocab tail from
    ``valid_vocab`` on is out of the softmax. Returns an f32 scalar;
    differentiable in h and emb."""
    return _MaskedCETied.apply(h, emb, labels, loss_mask, valid_vocab, block)


def masked_cross_entropy_fused(h: Tensor, emb: Tensor, labels: Tensor,
                               loss_mask: Tensor, valid_vocab: int) -> Tensor:
    """Entry point: picks the vocab block and runs :func:`masked_ce_tied`."""
    return masked_ce_tied(h, emb, labels, loss_mask, valid_vocab,
                          _pick_block(emb.shape[0]))
