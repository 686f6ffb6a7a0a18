"""Dataset factory (copy of bdm_db1_tpu/data/dataset_utils.py):
``--data.data-path (weight, prefix, type)*`` triples -> blended
train/valid/test datasets.

Parses the weighted spec, builds each entry's splits (type "nlp": a
``GPTDataset`` per split of an indexed corpus; any other type: a creator
from ``DATASET_CREATORS``, which the drivers fill, e.g. "rl" and
"rl_task_suite" from ``rl_dataset.make_rl_creator``), blends each split
with ``BlendableDataset`` (slot mode) and also returns the unblended valid
sets by type (``valid_no_blend``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bdm_db1_tpu_torch.data.blendable import BlendableDataset
from bdm_db1_tpu_torch.data.gpt_dataset import GPTDataset
from bdm_db1_tpu_torch.data.indexed_dataset import make_dataset


def get_datasets_weights_and_types(data_path: Sequence[str]):
    """(weights normalised to sum 1, prefixes, types) of the triples."""
    if len(data_path) % 3:
        raise ValueError("data-path must be (weight prefix type)*")
    weights, prefixes, types = [], [], []
    for i in range(0, len(data_path), 3):
        weights.append(float(data_path[i]))
        prefixes.append(data_path[i + 1])
        types.append(data_path[i + 2])
    s = sum(weights)
    return [w / s for w in weights], prefixes, types


def get_train_valid_test_split_(splits_string: str, size: int) -> List[int]:
    """'90,5,5'-style split boundaries [0, train_end, valid_end, size] over
    ``size`` items."""
    splits = [float(s) for s in splits_string.split(",")]
    while len(splits) < 3:
        splits.append(0.0)
    splits = splits[:3]
    total = sum(splits)
    if total <= 0:
        raise ValueError(f"split {splits_string!r} sums to {total}")
    splits = [s / total for s in splits]
    index = [0]
    for s in splits:
        index.append(index[-1] + int(round(s * float(size))))
    diff = index[-1] - size
    index = [max(0, i - diff) if n == 3 else i for n, i in enumerate(index)]
    index[-1] = size
    return index


def build_nlp_splits(prefix: str, splits_string: str, seq_length: int,
                     num_samples: Tuple[int, int, int], seed: int,
                     cache_dir: Optional[str] = None):
    """(train, valid, test) ``GPTDataset``s over the document split of the
    corpus at ``prefix``; None for an empty split or no samples."""
    indexed = make_dataset(prefix, impl="mmap")
    total_docs = len(indexed.doc_idx) - 1
    splits = get_train_valid_test_split_(splits_string, total_docs)
    out = []
    for i, name in enumerate(("train", "valid", "test")):
        if splits[i + 1] > splits[i] and num_samples[i] > 0:
            docs = np.arange(splits[i], splits[i + 1], dtype=np.int32)
            out.append(GPTDataset(
                f"{name}", indexed, docs, num_samples[i], seq_length,
                seed=seed, cache_dir=cache_dir))
        else:
            out.append(None)
    return tuple(out)


class NLPSampleAdapter:
    """A ``GPTDataset``'s items tagged ``"modality": "nlp"``."""

    def __init__(self, ds: GPTDataset):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx):
        item = self.ds[idx]
        item["modality"] = "nlp"
        return item


class RLSampleAdapter:
    """A dataset's items tagged ``"modality": "rl"``."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx):
        item = self.ds[idx]
        item["modality"] = "rl"
        return item


# dataset type -> creator; a module-level registry, as in the JAX package
# (the drivers register into it, and a later registration of a type
# replaces the earlier one)
DATASET_CREATORS: Dict[str, Callable] = {}


def register_creator(name: str, fn: Callable) -> None:
    """Creator signature: fn(prefix, split, seq_length, num_samples, seed,
    **ctx) -> (train, valid, test)."""
    DATASET_CREATORS[name] = fn


def build_train_valid_test_datasets(
    data_path: Sequence[str],
    splits_string: str,
    seq_length: int,
    train_valid_test_num_samples: Tuple[int, int, int],
    seed: int,
    global_batch_size: int,
    *,
    cache_dir: Optional[str] = None,
    creator_context: Optional[Dict] = None,
):
    """-> (train, valid, test, valid_no_blend): the first three blended
    over the entries that have the split (the dataset itself when one
    does, None when none does); valid_no_blend is {type: [valid sets]}."""
    weights, prefixes, types = get_datasets_weights_and_types(data_path)
    ctx = creator_context or {}

    trains, valids, tests = [], [], []
    valid_no_blend: Dict[str, List] = {}
    for prefix, typ in zip(prefixes, types):
        if typ == "nlp":
            tr, va, te = build_nlp_splits(
                prefix, splits_string, seq_length,
                train_valid_test_num_samples, seed, cache_dir=cache_dir)
            tr = NLPSampleAdapter(tr) if tr else None
            va = NLPSampleAdapter(va) if va else None
            te = NLPSampleAdapter(te) if te else None
        elif typ in DATASET_CREATORS:
            tr, va, te = DATASET_CREATORS[typ](
                prefix, splits_string, seq_length,
                train_valid_test_num_samples, seed, **ctx)
        else:
            raise ValueError(f"unknown dataset type {typ!r}")
        trains.append(tr)
        valids.append(va)
        tests.append(te)
        if va is not None:
            valid_no_blend.setdefault(typ, []).append(va)

    def blend(parts):
        live = [(p, w) for p, w in zip(parts, weights) if p is not None]
        if not live:
            return None
        if len(live) == 1:
            return live[0][0]
        return BlendableDataset(
            [p for p, _ in live], [w for _, w in live],
            global_batch_size=global_batch_size, seed=seed)

    return blend(trains), blend(valids), blend(tests), valid_no_blend
