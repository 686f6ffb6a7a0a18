"""Text tokenizers (copy of bdm_db1_tpu/tokenizers/text.py).

The data layer reads a minimal surface, ``vocab_size``, ``eos_token_id``,
batch ``__call__`` with padding/truncation, ``encode`` and ``decode``,
behind the ``TextTokenizer`` protocol:

* ``ByteTextTokenizer``: byte-level (ids = bytes + 1, id 0 =
  ``<|endoftext|>``), needs no files;
* ``HFTextTokenizer``: a pretrained HF fast tokenizer from a local
  directory (imports ``transformers`` when built);
* ``train_bpe_tokenizer``: trains a byte-level BPE of a given vocab size
  from an iterator of text and saves it HF-style (imports ``tokenizers``
  and ``transformers`` when called);
* ``build_text_tokenizer``: an explicit path, then ``$DB1_TOKENIZER_PATH``,
  then the byte tokenizer.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Protocol, Sequence


class TextTokenizer(Protocol):
    vocab_size: int
    eos_token_id: int

    def __call__(self, texts: Sequence[str], padding: Optional[str] = None,
                 truncation: bool = False,
                 max_length: Optional[int] = None) -> dict: ...

    def encode(self, text: str) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTextTokenizer:
    """Byte-level tokenizer: token = byte value + 1; id 0 is EOS/pad."""

    def __init__(self, vocab_size: int = 257):
        if vocab_size < 257:
            raise ValueError(f"a byte tokenizer needs vocab_size >= 257, "
                             f"got {vocab_size}")
        self.vocab_size = vocab_size
        self.eos_token_id = 0

    def encode(self, text: str) -> List[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - 1 for i in ids if 0 < i <= 256)
        return data.decode("utf-8", errors="replace")

    def __call__(self, texts, padding=None, truncation=False, max_length=None):
        # HF semantics: a bare string is one text, not a character sequence
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        out = []
        for t in texts:
            ids = self.encode(t)
            if truncation and max_length is not None:
                ids = ids[:max_length]
            if padding == "max_length" and max_length is not None:
                ids = ids + [self.eos_token_id] * (max_length - len(ids))
            out.append(ids)
        return {"input_ids": out[0] if single else out}


class HFTextTokenizer:
    """A HF fast tokenizer read from the local directory ``path``."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path)
        if self._tok.pad_token is None:
            self._tok.pad_token = self._tok.eos_token
        self.vocab_size = self._tok.vocab_size
        self.eos_token_id = self._tok.eos_token_id or 0

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids)

    def __call__(self, texts, padding=None, truncation=False, max_length=None):
        return self._tok(
            list(texts), padding=padding or False, truncation=truncation,
            max_length=max_length,
        )


def train_bpe_tokenizer(texts: Iterable[str], vocab_size: int,
                        save_path: str) -> HFTextTokenizer:
    """Train a byte-level BPE from scratch, save it HF-style to
    ``save_path`` and return it loaded from there."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=["<|endoftext|>"]
    )
    tok.train_from_iterator(texts, trainer=trainer)
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok,
        eos_token="<|endoftext|>",
        pad_token="<|endoftext|>",
    )
    fast.save_pretrained(save_path)
    return HFTextTokenizer(save_path)


def build_text_tokenizer(path: Optional[str] = None,
                         vocab_size: int = 32_000) -> TextTokenizer:
    """An explicit directory, then ``$DB1_TOKENIZER_PATH``, then the byte
    tokenizer (vocab ``max(vocab_size, 257)``)."""
    path = path or os.environ.get("DB1_TOKENIZER_PATH")
    if path and os.path.isdir(path):
        return HFTextTokenizer(path)
    return ByteTextTokenizer(max(vocab_size, 257))
