"""Packed language-modelling dataset over an indexed token corpus (copy of
bdm_db1_tpu/data/gpt_dataset.py; its maps and samples equal the JAX
package's).

Documents are flattened and cut into fixed ``seq_length + 1`` spans
through three index maps:

* ``doc_idx``     — the documents repeated ``num_epochs`` times, shuffled;
* ``sample_idx``  — (doc position, offset) span boundaries per sample
  (``native.build_sample_idx``);
* ``shuffle_idx`` — the sample order, the last (partial) epoch shuffled
  on its own when it covers less than 80% of an epoch.

With a ``cache_dir`` the maps are saved to
``<cache_dir>/<name>_<key>_indexmap_{n}ns_{L}sl_{seed}s_{doc,sample,shuffle}.npy``
and read back (mmap) when all three exist. ``key`` is a digest of the
documents and their sizes, the rest of what the maps depend on. The JAX
package leaves it out of its file names, so there two corpora that share a
cache directory and a split name read the first one's maps; the port's
files are its own and are not read from the JAX package's.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np

from bdm_db1_tpu_torch.data import native
from bdm_db1_tpu_torch.data.indexed_dataset import MMapIndexedDataset


class GPTDataset:
    def __init__(
        self,
        name: str,
        indexed: MMapIndexedDataset,
        documents: np.ndarray,
        num_samples: int,
        seq_length: int,
        seed: int = 1234,
        cache_dir: Optional[str] = None,
    ):
        self.name = name
        self.indexed = indexed
        self.seq_length = int(seq_length)
        if documents.min() < 0 or documents.max() >= len(indexed.sizes):
            raise ValueError(f"documents outside [0, {len(indexed.sizes)})")
        self.doc_idx, self.sample_idx, self.shuffle_idx = _build_index_mappings(
            name, indexed, documents, num_samples, seq_length, seed,
            cache_dir=cache_dir)

    def __len__(self) -> int:
        return self.sample_idx.shape[0] - 1

    def get_tokens(self, idx: int) -> np.ndarray:
        """The seq_length + 1 raw tokens (int64) of sample ``idx``."""
        idx = int(self.shuffle_idx[idx % len(self)])
        doc_f, off_f = self.sample_idx[idx]
        doc_l, off_l = self.sample_idx[idx + 1]
        if doc_f == doc_l:
            return self.indexed.get(
                self.doc_idx[doc_f], offset=int(off_f),
                length=int(off_l) - int(off_f) + 1).astype(np.int64)
        parts = [self.indexed.get(self.doc_idx[doc_f], offset=int(off_f))]
        for d in range(int(doc_f) + 1, int(doc_l)):
            parts.append(self.indexed[self.doc_idx[d]])
        parts.append(self.indexed.get(
            self.doc_idx[doc_l], length=int(off_l) + 1))
        return np.concatenate(parts).astype(np.int64)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        tokens = self.get_tokens(idx)
        return {
            "tokens": tokens[:-1].astype(np.int32),
            "label": tokens[1:].astype(np.int32),
            "loss_mask": np.ones(self.seq_length, dtype=np.float32),
        }


def get_ltor_masks_and_position_ids(
    tokens: np.ndarray,
    eod_token: int,
    reset_position_ids: bool = False,
    reset_attention_mask: bool = False,
    eod_mask_loss: bool = False,
):
    """Left-to-right (loss_mask, position_ids, attention_mask). The model
    builds the plain causal mask itself, so the attention mask is None
    unless a reset at EOD is asked for."""
    L = tokens.shape[-1]
    loss_mask = np.ones(tokens.shape, dtype=np.float32)
    if eod_mask_loss:
        loss_mask[tokens == eod_token] = 0.0
    position_ids = np.tile(np.arange(L, dtype=np.int64),
                           tokens.shape[:-1] + (1,))
    attention_mask = None
    if reset_position_ids or reset_attention_mask:
        attention_mask = np.tril(np.ones((L, L), dtype=np.int8))
        for b in range(tokens.shape[0] if tokens.ndim > 1 else 1):
            row = tokens[b] if tokens.ndim > 1 else tokens
            eods = np.nonzero(row == eod_token)[0]
            prev = 0
            for e in eods:
                if reset_attention_mask:
                    attention_mask[e + 1:, : e + 1] = 0
                if reset_position_ids and tokens.ndim > 1:
                    position_ids[b, e + 1:] -= (e + 1 - prev)
                    prev = e + 1
    return loss_mask, position_ids, attention_mask


def _maps_key(sizes, documents) -> str:
    """A digest of the documents and their sizes."""
    docs = np.asarray(documents, dtype=np.int64)
    digest = hashlib.sha1(docs.tobytes())
    digest.update(np.asarray(sizes[docs], dtype=np.int64).tobytes())
    return digest.hexdigest()[:16]


def _map_path(cache_dir, name, key, kind, num_samples, seq_length, seed):
    fname = (f"{name}_{key}_indexmap_{num_samples}ns_{seq_length}sl_"
             f"{seed}s_{kind}.npy")
    return os.path.join(cache_dir, fname)


def _build_index_mappings(name, indexed, documents, num_samples, seq_length,
                          seed, cache_dir=None):
    sizes = indexed.sizes
    tokens_per_epoch = int(np.sum(sizes[documents]))
    num_epochs = 1
    while (num_epochs * tokens_per_epoch - 1) // seq_length < num_samples:
        num_epochs += 1

    if cache_dir is not None:
        key = _maps_key(sizes, documents)
        paths = {k: _map_path(cache_dir, name, key, k, num_samples,
                              seq_length, seed)
                 for k in ("doc", "sample", "shuffle")}
        if all(os.path.exists(p) for p in paths.values()):
            return tuple(np.load(paths[k], mmap_mode="r")
                         for k in ("doc", "sample", "shuffle"))

    rng = np.random.RandomState(seed)

    # the last epoch is shuffled on its own when it is short
    separate_last = False
    if num_epochs > 1:
        samples_wo_last = ((num_epochs - 1) * tokens_per_epoch - 1) // seq_length
        last_epoch_samples = num_samples - samples_wo_last
        samples_per_epoch = (tokens_per_epoch - 1) // seq_length
        separate_last = (
            last_epoch_samples < int(0.80 * samples_per_epoch))

    doc_idx = _build_doc_idx(documents, num_epochs, rng, separate_last)
    sample_idx = native.build_sample_idx(
        sizes, doc_idx, seq_length, num_epochs, tokens_per_epoch)

    if separate_last:
        num_samples_ = ((num_epochs - 1) * tokens_per_epoch - 1) // seq_length
    else:
        num_samples_ = sample_idx.shape[0] - 1
    shuffle_idx = _build_shuffle_idx(
        num_samples_, sample_idx.shape[0] - 1, rng)

    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(paths["doc"], doc_idx)
        np.save(paths["sample"], sample_idx)
        np.save(paths["shuffle"], shuffle_idx)
    return doc_idx, sample_idx, shuffle_idx


def _build_doc_idx(documents, num_epochs, rng, separate_last):
    if not separate_last or num_epochs == 1:
        doc_idx = np.mgrid[0:num_epochs, 0:len(documents)][1]
        doc_idx[:] = documents
        doc_idx = doc_idx.reshape(-1).astype(np.int64)
        rng.shuffle(doc_idx)
        return doc_idx
    head = _build_doc_idx(documents, num_epochs - 1, rng, False)
    tail = _build_doc_idx(documents, 1, rng, False)
    return np.concatenate([head, tail])


def _build_shuffle_idx(num_samples, total_size, rng):
    """uint32 below 2^32 - 1 samples, else int64."""
    dtype = np.int64 if total_size >= (np.iinfo(np.uint32).max - 1) else np.uint32
    first = np.arange(num_samples, dtype=dtype)
    rng.shuffle(first)
    if num_samples == total_size:
        return first
    last = np.arange(num_samples, total_size, dtype=dtype)
    rng.shuffle(last)
    return np.concatenate([first, last])
