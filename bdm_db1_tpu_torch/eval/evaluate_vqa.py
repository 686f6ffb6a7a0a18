"""VQA evaluation (counterpart of bdm_db1_tpu/eval/evaluate_vqa.py, the
second module the reference imports but never shipped; reference:
src/train_utils/train.py:25).

Folds [prompt | image patches | question] into the K/V cache, greedy-decodes
an answer (eval/evaluate_ic.py ``CaptionGenerator``) and scores it with the
official VQA accuracy (eval/metrics.py ``vqa_accuracy``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bdm_db1_tpu_torch.core.vocab import VocabLayout
from bdm_db1_tpu_torch.eval.evaluate_ic import CaptionGenerator
from bdm_db1_tpu_torch.eval.metrics import vqa_accuracy

MAX_ANSWER_TOKENS = 10


def evaluate_vqa(model, dataset, layout: VocabLayout, eos_token_id: int,
                 text_tokenizer=None, num_samples: int = 0,
                 batch_size: int = 8) -> Dict[str, float]:
    """dataset: a ``VQADataset``. Answers compare as decoded strings with
    ``text_tokenizer``, else as token sequences (the human answers'
    ``answer_tokens`` where a fixture has them)."""
    gen = CaptionGenerator(model, layout, eos_token_id,
                           max_tokens=MAX_ANSWER_TOKENS)
    n = min(num_samples or len(dataset), len(dataset))
    accs: List[float] = []
    i = 0
    while i < n:
        idxs = list(range(i, min(i + batch_size, n)))
        items = [dataset.dataset[j] for j in idxs]  # CocoVQA items
        prompt = np.stack([it["prompt"] for it in items])
        images = np.stack([
            np.transpose(it["img"], (1, 2, 0)) for it in items])
        # the question is the text prefix (the answer is generated),
        # right-padded with EOS to a common length
        qmax = max(len(it["ques"]) for it in items)
        ques = np.full((len(items), qmax), eos_token_id, np.int64)
        for r, it in enumerate(items):
            ques[r, : len(it["ques"])] = it["ques"]
        answers = gen.generate(prompt, images, ques)
        for it, ans_tokens in zip(items, answers):
            qid = int(it["ques_id"])
            gt = dataset.dataset.vqa.qa[qid]
            humans = gt.get("answers", [])
            if text_tokenizer is not None:
                pred = text_tokenizer.decode(ans_tokens)
                human_strs = [h["answer"] for h in humans]
            else:  # token-space comparison for pre-tokenized fixtures
                pred = " ".join(map(str, ans_tokens))
                human_strs = [
                    " ".join(map(str, h["answer_tokens"]))
                    if "answer_tokens" in h else str(h["answer"])
                    for h in humans
                ]
            accs.append(vqa_accuracy(pred, human_strs))
        i += batch_size
    return {"vqa_accuracy": 100.0 * float(np.mean(accs)) if accs else 0.0,
            "num_evaluated": float(len(accs))}
