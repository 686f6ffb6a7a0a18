"""Image-captioning evaluation (counterpart of bdm_db1_tpu/eval/evaluate_ic.py,
the module the reference imports but never shipped; reference:
src/train_utils/train.py:24).

Greedy caption generation over the K/V cache: one forward folds the
[prompt | image patches | caption seed] prefix in over the aligned cache
(``prime_ic_kv``: K3 on the card), then one ring step a token
(``decode_text_kv``: K1 on the card) emits up to ``max_tokens`` tokens (30,
the reference text decoder's clip, src/data/text_decoder.py) per image.
The tokens stay on the device until the block is read back; EOS clipping
happens on the host.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from bdm_db1_tpu_torch.core.vocab import VocabLayout
from bdm_db1_tpu_torch.eval.decode import RkCache
from bdm_db1_tpu_torch.eval.generate import clip_at_eos, text_bias

MAX_CAPTION_TOKENS = 30


class CaptionGenerator:
    """Greedy text after an image prefix, on the model's device (captions,
    and VQA answers with the question as the text prefix)."""

    def __init__(self, model, layout: VocabLayout, eos_token_id: int,
                 max_tokens: int = MAX_CAPTION_TOKENS):
        self.model = model
        self.eos = eos_token_id
        self.max_tokens = max_tokens
        # text-only decoding: ban non-text ids and the padding tail
        self._bias = text_bias(layout, model.device)
        self._rk = RkCache(model)

    @torch.no_grad()
    def generate_tokens(self, prompt: np.ndarray, images: np.ndarray,
                        text_prefix: np.ndarray) -> torch.Tensor:
        """prompt [B, P] int; images [B, H, W, C]; text_prefix [B, T] (the
        caption seed, usually one EOS) -> [B, max_tokens] greedy token ids
        on the device, unclipped."""
        model = self.model
        dev = model.device
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                                 device=dev)
        text = torch.as_tensor(np.asarray(text_prefix), dtype=torch.int64,
                               device=dev)
        images = torch.as_tensor(np.asarray(images, np.float32), device=dev)
        b, h, w = images.shape[:3]
        p = model.vision_encoder.vision.patch_size
        q = prompt.shape[1] + (h // p) * (w // p) + text.shape[1]
        logits, cache = model.prime_ic_kv(prompt, images, text,
                                          model.init_kv_cache(b),
                                          self._rk.get(q))
        tok = torch.argmax(logits + self._bias, dim=-1)
        out = [tok]
        rk1 = self._rk.get(1)
        for _ in range(self.max_tokens - 1):
            logits, cache = model.decode_text_kv(tok[:, None], cache, rk1)
            tok = torch.argmax(logits + self._bias, dim=-1)
            out.append(tok)
        return torch.stack(out, dim=1)

    def generate(self, prompt: np.ndarray, images: np.ndarray,
                 text_prefix: np.ndarray) -> List[List[int]]:
        """As :meth:`generate_tokens`, read back: per-row token lists
        clipped at EOS."""
        toks = self.generate_tokens(prompt, images, text_prefix)
        return clip_at_eos(toks.cpu().numpy(), self.eos)


def evaluate_ic(model, dataset, layout: VocabLayout, eos_token_id: int,
                num_samples: int = 0, batch_size: int = 8
                ) -> Dict[str, float]:
    """Caption the first ``num_samples`` images of ``dataset`` (an
    ``ICDataset``; all of them at 0) and score them against their
    references: BLEU-1..4, ROUGE-L, CIDEr-D (reference: train.py evaluate
    path + coco_eval.py:37-84)."""
    from bdm_db1_tpu_torch.eval.metrics import evaluate_captions

    gen = CaptionGenerator(model, layout, eos_token_id)
    n = min(num_samples or len(dataset), len(dataset))
    results: Dict[int, Sequence] = {}
    gts: Dict[int, List[Sequence]] = {}
    i = 0
    while i < n:
        idxs = list(range(i, min(i + batch_size, n)))
        items = [dataset.dataset[j] for j in idxs]  # RandomCOCO items
        prompt = np.stack([it["prompt"] for it in items])
        images = np.stack([
            np.transpose(it["img"], (1, 2, 0)) for it in items])
        seed = np.full((len(items), 1), eos_token_id, np.int64)
        caps = gen.generate(prompt, images, seed)
        for it, cap in zip(items, caps):
            img_id = int(it["img_id"])
            results[img_id] = cap
            anns = dataset.dataset.coco.img_to_anns[img_id]
            gts[img_id] = [list(a["caption"]) for a in anns]
        i += batch_size
    return evaluate_captions(results, gts)
