"""Autoregressive text generation over the K/V cache (counterpart of
bdm_db1_tpu/eval/generate.py).

The prompt folds into the cache in one forward (``decode_text_kv``: the
ring up to ``MAX_PRIME_Q`` tokens, the aligned route, K3 on the card,
above), then one ring step a token (K1 on the card) emits ``max_tokens``
tokens with greedy, temperature, top-k or top-p decoding. Draws come from
an explicit ``torch.Generator``; the JAX package's threefry draws are not
reproduced, so only greedy outputs (and filters that keep one token) equal
its. The tokens stay on the device until the whole block is read back;
EOS clipping happens on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from bdm_db1_tpu_torch.core.vocab import VocabLayout
from bdm_db1_tpu_torch.eval.decode import RkCache

Tensor = torch.Tensor


def _sample(logits: Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: int, top_p: float) -> Tensor:
    """One token a row of logits [B, V]: the argmax at temperature 0;
    otherwise a draw from softmax(logits / temperature) after top-k (keep
    the k largest) and top-p (keep the smallest set of largest logits whose
    probability reaches top_p) filtering, as the JAX package filters."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits / temperature, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # the last logit inside the nucleus
        inside = cum - probs < top_p
        cutoff = torch.where(inside, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -1e30, logits)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def text_bias(layout: VocabLayout, device) -> Tensor:
    """[V] f32: 0 on the text ids, -1e10 on every other id and the pad
    tail (text-only decoding)."""
    bias = np.zeros((layout.padded_vocab_size,), np.float32)
    bias[layout.text_vocab_size:] = -1e10
    return torch.as_tensor(bias, device=device)


def clip_at_eos(rows: np.ndarray, eos: int) -> List[List[int]]:
    """Each row's tokens up to its first EOS."""
    out = []
    for row in rows.tolist():
        out.append(row[:row.index(eos)] if eos in row else row)
    return out


class TextGenerator:
    """Batched LM generation: prompts -> continuations, on the model's
    device, over the K/V cache (post-LN models; a pre-LN one raises
    ``ValueError``)."""

    def __init__(self, model, layout: VocabLayout, eos_token_id: int, *,
                 max_tokens: int = 64, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0):
        if model.cfg.pre_lnorm:
            raise ValueError("K/V generation needs a post-LN model: the "
                             "zero K/V cache is not a pre-LN model's zero "
                             "memory")
        self.model = model
        self.eos = eos_token_id
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self._bias = text_bias(layout, model.device)
        self._rk = RkCache(model)

    @torch.no_grad()
    def generate_tokens(self, prompts: np.ndarray,
                        generator: Optional[torch.Generator] = None
                        ) -> Tensor:
        """prompts [B, P] int -> [B, max_tokens] token ids on the device,
        unclipped. Sampling draws from ``generator`` (default: a generator
        on the model's device seeded 0)."""
        model = self.model
        dev = model.device
        if generator is None and self.temperature != 0.0:
            generator = torch.Generator(device=dev).manual_seed(0)
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                 device=dev)
        logits, cache = model.decode_text_kv(
            tokens, model.init_kv_cache(tokens.shape[0]),
            self._rk.get(tokens.shape[1]))

        def sample(lg):
            return _sample(lg + self._bias, generator, self.temperature,
                           self.top_k, self.top_p)

        tok = sample(logits)
        out = [tok]
        rk1 = self._rk.get(1)
        for _ in range(self.max_tokens - 1):
            logits, cache = model.decode_text_kv(tok[:, None], cache, rk1)
            tok = sample(logits)
            out.append(tok)
        return torch.stack(out, dim=1)

    def generate(self, prompts: np.ndarray,
                 generator: Optional[torch.Generator] = None
                 ) -> List[List[int]]:
        """prompts: [B, P] int token ids (pad with EOS to a common length).
        Returns per-row continuations clipped at EOS."""
        toks = self.generate_tokens(prompts, generator).cpu().numpy()
        return clip_at_eos(toks, self.eos)

    def generate_text(self, tokenizer, texts: Sequence[str],
                      generator: Optional[torch.Generator] = None
                      ) -> List[str]:
        """Encode ``texts``, right-pad them with EOS to a common length (as
        the JAX package does), generate and decode."""
        enc = [tokenizer.encode(t) for t in texts]
        width = max(len(e) for e in enc)
        prompts = np.full((len(enc), width), self.eos, np.int64)
        for i, e in enumerate(enc):
            prompts[i, : len(e)] = e
        return [tokenizer.decode(ids)
                for ids in self.generate(prompts, generator)]
