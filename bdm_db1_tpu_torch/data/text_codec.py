"""Corpus text encode/decode helpers (copy of bdm_db1_tpu/data/text_codec.py).

``Encoder`` splits a document into sentences (nltk punkt when it is
installed with its data, else a regex on sentence-ending punctuation),
encodes each and appends EOD; ``Decoder`` decodes at most ``max_tokens``
tokens, clipped at the first EOS.
"""

from __future__ import annotations

import re
from typing import List, Sequence


def split_sentences(text: str) -> List[str]:
    try:
        import nltk

        try:
            return nltk.tokenize.sent_tokenize(text)
        except LookupError:
            pass
    except ImportError:
        pass
    parts = re.split(r"(?<=[.!?])\s+", text.strip())
    return [p for p in parts if p]


class Encoder:
    """Document -> sentence-split token ids + EOD."""

    def __init__(self, tokenizer, append_eod: bool = True,
                 split_into_sentences: bool = True):
        self.tokenizer = tokenizer
        self.append_eod = append_eod
        self.split = split_into_sentences

    def encode(self, text: str) -> List[List[int]]:
        """A list of sentence token lists; the last carries EOD."""
        sentences = split_sentences(text) if self.split else [text]
        out = [self.tokenizer.encode(s) for s in sentences if s]
        out = [ids for ids in out if ids]
        if out and self.append_eod:
            out[-1] = out[-1] + [self.tokenizer.eos_token_id]
        return out

    def encode_flat(self, text: str) -> List[int]:
        return [t for sent in self.encode(text) for t in sent]


class Decoder:
    """Token ids -> text, clipped at EOS and at ``max_tokens``."""

    def __init__(self, tokenizer, max_tokens: int = 30):
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens

    def decode(self, ids: Sequence[int]) -> str:
        clipped = []
        for t in list(ids)[: self.max_tokens]:
            if t == self.tokenizer.eos_token_id:
                break
            clipped.append(int(t))
        return self.tokenizer.decode(clipped)
