"""Caption/VQA metrics, dependency-free (counterpart of
bdm_db1_tpu/eval/metrics.py, the same pure Python).

The reference delegates to pycocotools + a forked mycocoevalcap and imports
a ``vqaEval`` module it never ships (reference: src/data/coco_eval.py:28,
37-119; SURVEY.md §2.9). Implemented here directly:

* BLEU-1..4 (corpus-level, uniform weights, standard brevity penalty),
* CIDEr-D (n<=4 TF-IDF cosine with length gaussian, sigma 6),
* ROUGE-L (corpus mean F with beta=1.2),
* VQA accuracy: min(#humans-matching/3, 1), averaged over 10-choose-9
  subsets as in the official evaluator.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def corpus_bleu(hypotheses: List[Sequence], references: List[List[Sequence]],
                max_n: int = 4) -> List[float]:
    """Returns [BLEU-1, ..., BLEU-max_n]."""
    assert len(hypotheses) == len(references)
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        hyp_len += len(hyp)
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hg = _ngrams(hyp, n)
            max_ref = Counter()
            for r in refs:
                rg = _ngrams(r, n)
                for g, c in rg.items():
                    max_ref[g] = max(max_ref[g], c)
            totals[n - 1] += max(0, len(hyp) - n + 1)
            clipped[n - 1] += sum(min(c, max_ref[g]) for g, c in hg.items())
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    out = []
    logp_sum = 0.0
    for n in range(1, max_n + 1):
        p = clipped[n - 1] / totals[n - 1] if totals[n - 1] else 0.0
        logp_sum += math.log(p) if p > 0 else -1e9
        out.append(bp * math.exp(logp_sum / n))
    return out


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------

def cider_d(hypotheses: List[Sequence], references: List[List[Sequence]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    # document frequencies over reference sets
    df = [defaultdict(int) for _ in range(max_n)]
    for refs in references:
        for n in range(1, max_n + 1):
            seen = set()
            for r in refs:
                seen |= set(_ngrams(r, n).keys())
            for g in seen:
                df[n - 1][g] += 1
    num_imgs = len(references)
    log_num = math.log(max(num_imgs, 1))

    def tfidf_vec(tokens, n):
        cnt = _ngrams(tokens, n)
        total = max(sum(cnt.values()), 1)
        vec = {}
        norm = 0.0
        for g, c in cnt.items():
            idf = log_num - math.log(max(df[n - 1].get(g, 0), 1))
            w = (c / total) * idf
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for hyp, refs in zip(hypotheses, references):
        score_n = []
        for n in range(1, max_n + 1):
            hv, hnorm = tfidf_vec(hyp, n)
            s = 0.0
            for r in refs:
                rv, rnorm = tfidf_vec(r, n)
                sim = sum(min(hv[g], rv.get(g, 0.0)) * rv.get(g, 0.0)
                          for g in hv)
                if hnorm > 0 and rnorm > 0:
                    sim /= hnorm * rnorm
                delta = len(hyp) - len(r)
                sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                s += sim
            score_n.append(10.0 * s / max(len(refs), 1))
        scores.append(sum(score_n) / max_n)
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs(a: Sequence, b: Sequence) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(hypotheses: List[Sequence], references: List[List[Sequence]],
            beta: float = 1.2) -> float:
    scores = []
    for hyp, refs in zip(hypotheses, references):
        best = 0.0
        for r in refs:
            l = _lcs(hyp, r)
            p = l / max(len(hyp), 1)
            rr = l / max(len(r), 1)
            if p > 0 and rr > 0:
                f = ((1 + beta ** 2) * p * rr) / (rr + beta ** 2 * p)
                best = max(best, f)
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


def evaluate_captions(results: Dict[int, Sequence],
                      gts: Dict[int, List[Sequence]]) -> Dict[str, float]:
    """results: image id -> token sequence; gts: id -> reference token lists.
    Returns the metric dict the reference prints
    (reference: src/data/coco_eval.py:37-84, minus SPICE per its skip list)."""
    ids = sorted(results.keys())
    hyps = [list(results[i]) for i in ids]
    refs = [[list(r) for r in gts[i]] for i in ids]
    b = corpus_bleu(hyps, refs)
    return {
        "Bleu_1": b[0], "Bleu_2": b[1], "Bleu_3": b[2], "Bleu_4": b[3],
        "ROUGE_L": rouge_l(hyps, refs),
        "CIDEr": cider_d(hyps, refs),
    }


# ---------------------------------------------------------------------------
# VQA accuracy (the reference's missing vqaEval module, SURVEY.md §2.9)
# ---------------------------------------------------------------------------

def vqa_accuracy(answer: str, human_answers: List[str]) -> float:
    """Official VQA metric: average over all 10-choose-9 human subsets of
    min(#matches/3, 1)."""
    answer = normalize_answer(answer)
    human = [normalize_answer(a) for a in human_answers]
    n = len(human)
    if n == 0:
        return 0.0
    if n == 1:
        return float(human[0] == answer)
    accs = []
    for i in range(n):
        others = human[:i] + human[i + 1:]
        accs.append(min(sum(1 for a in others if a == answer) / 3.0, 1.0))
    return sum(accs) / n


_CONTRACTIONS = {"arent": "aren't", "cant": "can't", "couldnt": "couldn't",
                 "dont": "don't", "doesnt": "doesn't", "isnt": "isn't",
                 "wont": "won't", "wouldnt": "wouldn't", "youre": "you're"}
_ARTICLES = {"a", "an", "the"}
_NUMBERS = {"zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
            "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
            "ten": "10"}


def normalize_answer(ans: str) -> str:
    import re

    ans = ans.lower().strip()
    ans = re.sub(r"[\.\,\?\!\;\:\"\(\)]", "", ans)
    words = []
    for w in ans.split():
        w = _NUMBERS.get(w, w)
        w = _CONTRACTIONS.get(w, w)
        if w not in _ARTICLES:
            words.append(w)
    return " ".join(words)


class VQAEval:
    """Accuracy aggregator with the reference evaluator's API shape."""

    def __init__(self, vqa=None, vqa_res=None):
        self.vqa = vqa
        self.vqa_res = vqa_res
        self.accuracy: Dict[str, float] = {}

    def evaluate(self, ques_ids=None) -> float:
        assert self.vqa is not None and self.vqa_res is not None
        ques_ids = ques_ids or sorted(self.vqa_res.qa.keys())
        per_q = []
        per_type = defaultdict(list)
        for qid in ques_ids:
            gt = self.vqa.qa[qid]
            res = self.vqa_res.qa[qid]
            humans = [a["answer"] for a in gt.get("answers", [])]
            acc = vqa_accuracy(res["answer"], humans)
            per_q.append(acc)
            if gt.get("answer_type"):
                per_type[gt["answer_type"]].append(acc)
        overall = 100.0 * sum(per_q) / max(len(per_q), 1)
        self.accuracy = {"overall": overall}
        for t, accs in per_type.items():
            self.accuracy[t] = 100.0 * sum(accs) / len(accs)
        return overall
