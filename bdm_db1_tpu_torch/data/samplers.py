"""Sample order and host-side batch assembly (the sequential sampler and the
modality collate of bdm_db1_tpu/data/samplers.py). The random sampler and
the threaded stratified loader come with the training slice."""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


class SequentialSampler:
    """Sequential sample order sharded by data-parallel rank, resuming at
    ``consumed_samples``; yields micro-batches of indices forever."""

    def __init__(self, total_samples: int, consumed_samples: int,
                 micro_batch_size: int, dp_rank: int, dp_size: int):
        self.total = total_samples
        self.consumed = consumed_samples
        self.micro = micro_batch_size
        self.rank = dp_rank
        self.world = dp_size

    def __iter__(self) -> Iterator[List[int]]:
        batch = []
        idx = self.consumed
        while True:
            batch.append(idx % self.total)
            idx += 1
            if len(batch) == self.micro * self.world:
                lo = self.rank * self.micro
                yield batch[lo: lo + self.micro]
                batch = []


def collate_modalities(samples: Sequence[Dict[str, np.ndarray]],
                       modalities: Sequence[str]) -> Dict[str, Dict]:
    """Group sample dicts by ``samples[i]["modality"]`` (default "rl") and
    stack each field: {modality: {field: [n, ...]}}."""
    groups: Dict[str, List] = {m: [] for m in modalities}
    for s in samples:
        groups[s.get("modality", "rl")].append(s)
    out = {}
    for m, items in groups.items():
        if not items:
            continue
        keys = [k for k in items[0] if k != "modality"]
        out[m] = {k: np.stack([it[k] for it in items]) for k in keys}
    return out
