"""Sample order and host-side batch assembly (counterpart of
bdm_db1_tpu/data/samplers.py): the sequential and random samplers, sharded
by data-parallel rank with ``consumed_samples`` resume, the modality
collate, ``RandomSeedDataset`` (global RNGs reseeded per sample), the
fixed per-modality mixture counts, the threaded stratified loader that
yields ``{modality: {field: [accum, c_m, ...]}}`` numpy batches of the
same structure every step, and the single-dataset ``PrefetchLoader``."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

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


class RandomSampler:
    """Epoch-seeded permutation, sharded by data-parallel rank, resumable
    at ``consumed_samples``."""

    def __init__(self, total_samples: int, consumed_samples: int,
                 micro_batch_size: int, dp_rank: int, dp_size: int,
                 seed: int = 1234):
        self.total = total_samples
        self.consumed = consumed_samples
        self.micro = micro_batch_size
        self.rank = dp_rank
        self.world = dp_size
        self.seed = seed

    def _index_stream(self) -> Iterator[int]:
        epoch = self.consumed // self.total
        offset = self.consumed % self.total
        while True:
            perm = np.random.RandomState(self.seed + epoch).permutation(
                self.total)
            yield from perm[offset:].tolist()
            offset = 0
            epoch += 1

    def __iter__(self) -> Iterator[List[int]]:
        stream = self._index_stream()
        step = self.micro * self.world
        while True:
            block = [next(stream) for _ in range(step)]
            self.consumed += step
            lo = self.rank * self.micro
            yield block[lo: lo + self.micro]


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


class RandomSeedDataset:
    """Reseeds Python's and numpy's global RNGs from ``base_seed + idx``
    before each item, so worker threads cannot change what an item's
    random augmentations draw."""

    def __init__(self, dataset, base_seed: int = 1234):
        self.dataset = dataset
        self.base_seed = base_seed

    def __len__(self) -> int:
        return len(self.dataset)

    def set_epoch(self, epoch: int) -> None:
        self.base_seed += epoch

    def __getitem__(self, idx: int):
        import random

        seed = self.base_seed + int(idx)
        random.seed(seed)
        np.random.seed(seed % (2 ** 32))
        return self.dataset[idx]


def mixture_counts(weights: Dict[str, float], micro_batch_size: int
                   ) -> Dict[str, int]:
    """Per-micro-batch sample counts per modality, fixed across steps:
    rounded shares of ``micro_batch_size``, the drift fixed on the
    heaviest modality, no modality dropped to zero by the fix."""
    total = sum(weights.values())
    names = sorted(weights)
    counts = {m: int(round(weights[m] / total * micro_batch_size))
              for m in names}
    while sum(counts.values()) < micro_batch_size:
        counts[max(names, key=lambda m: weights[m])] += 1
    while sum(counts.values()) > micro_batch_size:
        counts[max(names, key=lambda m: counts[m])] -= 1
    return {m: c for m, c in counts.items() if c > 0}


class StratifiedGatoLoader:
    """Mixed-modality batches with fixed per-modality micro counts: every
    ``__next__`` returns {modality: {field: [accum, c_m, ...]}}, the same
    structure every step. Sample order comes from the given samplers;
    ``num_threads`` worker threads assemble batches ahead (numpy releases
    the GIL), at most ``max_prefetch`` of them. A worker's error is raised
    to the consumer; ``stop()`` ends the workers."""

    def __init__(self, datasets: Dict[str, object],
                 samplers: Dict[str, object],
                 counts: Dict[str, int], accum_steps: int,
                 num_threads: int = 2, max_prefetch: int = 4):
        if not set(datasets) == set(samplers) == set(counts):
            raise ValueError("datasets, samplers and counts must name the "
                             "same modalities")
        self.datasets = datasets
        self.iters = {m: iter(s) for m, s in samplers.items()}
        self.counts = counts
        self.accum = accum_steps
        self._q: queue.Queue = queue.Queue(maxsize=max_prefetch)
        self._err: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(1, num_threads))]
        for t in self._threads:
            t.start()

    def _draw_indices(self):
        with self._lock:
            return {m: [next(self.iters[m]) for _ in range(self.accum)]
                    for m in self.counts}

    def _worker(self):
        while not self._stop.is_set():
            try:
                plan = self._draw_indices()
                batch = {}
                for m, accum_lists in plan.items():
                    micros = []
                    for idx_list in accum_lists:
                        samples = [self.datasets[m][i] for i in idx_list]
                        keys = [k for k in samples[0] if k != "modality"]
                        micros.append({k: np.stack([s[k] for s in samples])
                                       for k in keys})
                    batch[m] = {k: np.stack([mi[k] for mi in micros])
                                for k in micros[0]}
                # a timed put, so a worker blocked on a full queue still
                # sees stop() and exits
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.2)
                        break
                    except queue.Full:
                        continue
            except StopIteration:
                break
            except Exception as e:  # raised to the consumer by __next__
                self._err.put(e)
                break

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if not self._err.empty():
                raise self._err.get()
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if all(not t.is_alive() for t in self._threads):
                    raise StopIteration

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)


class PrefetchLoader:
    """Prefetching loader over one dataset: each item is the sampler's next
    ``accum_steps`` index lists stacked to {field: [accum, micro, ...]}
    (``to_batch`` applied when given), assembled by a
    ``StratifiedGatoLoader`` of one group; ``stop()`` ends its workers."""

    def __init__(self, dataset, sampler, *, accum_steps: int = 1,
                 num_threads: int = 2, max_prefetch: int = 4,
                 to_batch: Optional[Callable] = None):
        self._loader = StratifiedGatoLoader(
            {"": dataset}, {"": sampler}, {"": None}, accum_steps,
            num_threads=num_threads, max_prefetch=max_prefetch)
        self.to_batch = to_batch

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._loader)[""]
        return batch if self.to_batch is None else self.to_batch(batch)

    def stop(self) -> None:
        self._loader.stop()
