"""Weighted multi-dataset mixture (copy of bdm_db1_tpu/data/blendable.py).

Two modes:

* ``slot`` (the default) — the weights round to per-global-batch slot
  counts; batch slot i always draws from the same dataset, a random
  element of it from one shared ``np.random.RandomState(seed)``, so the
  sequence depends on the order of the calls (one loader thread gives
  the JAX package's sequence);
* ``index`` — a precomputed error-minimizing index over the whole length
  (``native.build_blending_indices``), deterministic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from bdm_db1_tpu_torch.data import native


class BlendableDataset:
    def __init__(
        self,
        datasets: Sequence,
        weights: Sequence[float],
        global_batch_size: Optional[int] = None,
        *,
        mode: str = "slot",
        size: Optional[int] = None,
        seed: int = 1234,
    ):
        if not datasets or len(datasets) != len(weights):
            raise ValueError("one weight per dataset, and at least one")
        self.datasets = list(datasets)
        w = np.asarray(weights, dtype=np.float64)
        self.weights = w / w.sum()
        self.mode = mode
        self.rng = np.random.RandomState(seed)
        self._size = size or sum(len(d) for d in self.datasets)

        if mode == "slot":
            if global_batch_size is None:
                raise ValueError("slot mode needs the global batch size")
            counts = np.round(self.weights * global_batch_size).astype(int)
            # fix the rounding drift so every slot maps somewhere
            while counts.sum() < global_batch_size:
                counts[int(np.argmax(self.weights))] += 1
            while counts.sum() > global_batch_size:
                counts[int(np.argmax(counts))] -= 1
            self._slot_map = np.repeat(
                np.arange(len(counts), dtype=np.int32), counts)
            self.global_batch_size = global_batch_size
        else:
            self._ds_index, self._ds_sample = native.build_blending_indices(
                self.weights, self._size)

    def __len__(self) -> int:
        return self._size

    def __getitem__(self, idx: int):
        if self.mode == "slot":
            ds_i = int(self._slot_map[idx % self.global_batch_size])
            ds = self.datasets[ds_i]
            return ds[int(self.rng.randint(len(ds)))]
        ds = self.datasets[int(self._ds_index[idx % self._size])]
        return ds[int(self._ds_sample[idx % self._size]) % len(ds)]
