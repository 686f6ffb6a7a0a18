"""Corpus preprocessing CLI: jsonl or plain text -> Megatron ``.bin/.idx``
(copy of bdm_db1_tpu/data/preprocess.py; its files are byte-equal to the
JAX tool's).

    python -m bdm_db1_tpu_torch.data.preprocess \
        --input corpus.jsonl --json-key text \
        --output-prefix /data/corpus --tokenizer-path my_tokenizer \
        --workers 8

Documents are sentence-split and encoded (``text_codec.Encoder``),
EOD-terminated and appended through the builder (``--dataset-impl``
mmap or lazy); uint16 storage when the vocab allows. Without a tokenizer
directory (``--tokenizer-path`` or ``$DB1_TOKENIZER_PATH``) the byte
tokenizer encodes. ``--workers`` > 1 encodes in a pool of spawned
processes, in document order.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import time
from typing import Dict, Iterator, List

from bdm_db1_tpu_torch.data.indexed_dataset import make_builder
from bdm_db1_tpu_torch.data.text_codec import Encoder
from bdm_db1_tpu_torch.tokenizers.text import build_text_tokenizer

_ENC = None   # a pool worker's encoder, set by _init_worker in that process


def _make_encoder(tokenizer_path: str, vocab_size: int, split: bool):
    tok = build_text_tokenizer(tokenizer_path, vocab_size)
    return Encoder(tok, append_eod=True, split_into_sentences=split)


def _init_worker(tokenizer_path: str, vocab_size: int, split: bool):
    global _ENC
    _ENC = _make_encoder(tokenizer_path, vocab_size, split)


def _encode_doc(text: str) -> List[int]:
    return _ENC.encode_flat(text)


def _iter_docs(path: str, json_key: str) -> Iterator[str]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if json_key:
                try:
                    yield json.loads(line)[json_key]
                except (json.JSONDecodeError, KeyError):
                    continue
            else:
                yield line


def main(argv=None) -> Dict[str, float]:
    """Run the tool; returns {"docs", "tokens", "seconds"} of what it
    wrote (also printed to stderr)."""
    ap = argparse.ArgumentParser("preprocess")
    ap.add_argument("--input", required=True)
    ap.add_argument("--json-key", default="",
                    help="jsonl field holding the text; empty = plain lines")
    ap.add_argument("--output-prefix", required=True)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--vocab-size", type=int, default=32_000)
    ap.add_argument("--dataset-impl", default="mmap",
                    choices=["mmap", "lazy"])
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--no-sentence-split", action="store_true")
    args = ap.parse_args(argv)

    builder = make_builder(args.output_prefix, impl=args.dataset_impl,
                           vocab_size=args.vocab_size)
    docs = _iter_docs(args.input, args.json_key)
    enc_args = (args.tokenizer_path, args.vocab_size,
                not args.no_sentence_split)
    t0 = time.perf_counter()
    n_docs = n_tokens = 0

    def add(ids):
        nonlocal n_docs, n_tokens
        if ids:
            builder.add_document(ids)
            n_docs += 1
            n_tokens += len(ids)

    if args.workers > 1:
        with mp.get_context("spawn").Pool(
                args.workers, initializer=_init_worker,
                initargs=enc_args) as pool:
            for ids in pool.imap(_encode_doc, docs, chunksize=32):
                add(ids)
    else:
        enc = _make_encoder(*enc_args)
        for text in docs:
            add(enc.encode_flat(text))

    builder.finalize()
    dt = time.perf_counter() - t0
    print(f"wrote {n_docs} docs / {n_tokens} tokens to "
          f"{args.output_prefix}.bin (+.idx) in {dt:.1f}s "
          f"({n_tokens / max(dt, 1e-9):,.0f} tok/s)", file=sys.stderr)
    return {"docs": n_docs, "tokens": n_tokens, "seconds": dt}


if __name__ == "__main__":
    main()
