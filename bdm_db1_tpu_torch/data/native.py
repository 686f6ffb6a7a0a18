"""Dataset index builders (copy of bdm_db1_tpu/data/native.py, in numpy and
Python; every output equals the JAX package's, as its C++ helper library
computes it).

* ``build_rl_sample_idx(path_lengths, transition_num)`` — (path, start,
  end) rows, one per timestep, so a trajectory of length n yields n
  samples (the original reference yields n - 1; the port matches the JAX
  package);
* ``build_sample_idx(sizes, doc_idx, seq_length, num_epochs,
  tokens_per_epoch)`` — the GPT packed-sample index, vectorised: a
  cumulative sum and a search over the document sizes;
* ``build_blending_indices(weights, size)`` — error-minimizing weighted
  round-robin, with the C++ helper's once-rounded errors: a C loop
  (csrc/blending.c, built with the system C compiler into ``build/native/``
  at first use and loaded with ctypes; a failed build raises with the
  compiler's output), whose plain Python version is
  ``build_blending_indices_plain``;
* ``build_mapping`` / ``build_blocks_mapping`` — the BERT sentence-group
  and ICT block maps, with the ``std::mt19937`` / ``std::mt19937_64`` draw
  sequences of the C++ original bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

_BLEND_SRC = Path(__file__).resolve().parent.parent / "csrc" / "blending.c"
_NATIVE_BUILD = Path(__file__).resolve().parents[2] / "build" / "native"
# -ffp-contract=off: the one fused multiply-add is the explicit fma()
CC_FLAGS = ("-O2", "-std=c99", "-shared", "-fPIC", "-ffp-contract=off")


def build_rl_sample_idx(path_lengths: Sequence[int],
                        transition_num: int) -> np.ndarray:
    """[sum(lengths), 3] int64 rows (path, start, end) with
    end = min(start + transition_num, length), one per timestep."""
    lengths = np.asarray(path_lengths, dtype=np.int64)
    out = np.empty((int(lengths.sum()), 3), dtype=np.int64)
    row = 0
    for p, n in enumerate(lengths):
        n = int(n)
        starts = np.arange(n, dtype=np.int64)
        out[row: row + n, 0] = p
        out[row: row + n, 1] = starts
        out[row: row + n, 2] = np.minimum(starts + transition_num, n)
        row += n
    return out


def build_sample_idx(
    sizes: np.ndarray,
    doc_idx: np.ndarray,
    seq_length: int,
    num_epochs: int,
    tokens_per_epoch: int,
) -> np.ndarray:
    """GPT token-packing index: [num_samples + 1, 2] int64 rows (position
    in ``doc_idx``, offset), so sample i spans the tokens from row i to row
    i + 1, both ends included (seq_length + 1 tokens; the boundary token is
    shared with the next sample, Megatron's semantics).

    Row i > 0 is the token at flat position i * seq_length of the
    ``doc_idx``-ordered stream: the document holding it (empty documents
    hold none) and the offset in it. Row 0 is (0, 0)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    doc_idx = np.asarray(doc_idx, dtype=np.int64)
    num_samples = (num_epochs * tokens_per_epoch - 1) // seq_length
    out = np.zeros((num_samples + 1, 2), dtype=np.int64)
    if num_samples <= 0:
        return out
    ends = np.cumsum(sizes[doc_idx])                  # exclusive doc ends
    pos = np.arange(1, num_samples + 1, dtype=np.int64) * seq_length
    doc = np.searchsorted(ends, pos, side="right")
    out[1:, 0] = doc
    out[1:, 1] = pos - (ends[doc] - sizes[doc_idx[doc]])
    return out


def _compiler() -> str:
    for cand in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no C compiler found (CC, cc, gcc, clang): the "
                       "blending index is built from csrc/blending.c")


@functools.lru_cache(maxsize=None)
def _blend_lib() -> ctypes.CDLL:
    """csrc/blending.c built at first use into ``build/native/``, named by
    the source's hash (written under a temporary name and renamed, so
    processes that build at once never load a partial file)."""
    src = _BLEND_SRC.read_bytes()
    out = _NATIVE_BUILD / (
        f"blending-{hashlib.sha1(src).hexdigest()[:12]}.so")
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_compiler(), *CC_FLAGS, "-o", str(tmp), str(_BLEND_SRC), "-lm"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {_BLEND_SRC.name} failed "
                               f"({proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    lib.bdm_build_blending_indices.argtypes = [P, LL, LL, P, P]
    lib.bdm_build_blending_indices.restype = ctypes.c_int
    return lib


def build_blending_indices(
    weights: np.ndarray, size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(dataset_index int32 [size], dataset_sample_index int64 [size]):
    entry i takes the dataset with the largest error weight * (i + 1) -
    count (the first on a tie) and that dataset's next sample. The C loop
    of csrc/blending.c; equal to :func:`build_blending_indices_plain`."""
    w = np.ascontiguousarray(weights, dtype=np.float64)
    ds_index = np.empty(size, dtype=np.int32)
    ds_sample = np.empty(size, dtype=np.int64)
    rc = _blend_lib().bdm_build_blending_indices(
        w.ctypes.data, len(w), size, ds_index.ctypes.data,
        ds_sample.ctypes.data)
    if rc:
        raise MemoryError(f"build_blending_indices: no memory for "
                          f"{len(w)} counts")
    return ds_index, ds_sample


def build_blending_indices_plain(
    weights: np.ndarray, size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of :func:`build_blending_indices`, a Python loop.
    The error is rounded once, from its exact value, as the JAX package's
    C++ helper computes it (built with ``-march=native``, the compiler
    fuses the multiply and the subtract). Its numpy fallback rounds the
    product first, which breaks some ties the other way (weights 0.7 /
    0.2 / 0.1 at i = 4: 0.7 * 5 rounds to 3.5)."""
    ratios = [float(x).as_integer_ratio()
              for x in np.asarray(weights, dtype=np.float64)]
    counts = [0] * len(ratios)
    ds_index = np.empty(size, dtype=np.int32)
    ds_sample = np.empty(size, dtype=np.int64)
    for i in range(size):
        best, best_err = 0, -np.inf
        for j, (num, den) in enumerate(ratios):
            # an int / int true division is correctly rounded
            err = (num * (i + 1) - counts[j] * den) / den
            if err > best_err:
                best, best_err = j, err
        ds_index[i] = best
        ds_sample[i] = counts[best]
        counts[best] += 1
    return ds_index, ds_sample


# ---- BERT/ICT sentence-block maps -------------------------------------------

_LONG_SENTENCE_LEN = 512


class _MT19937:
    """std::mt19937: the standard's seed initialisation and tempering."""

    _N, _M, _A = 624, 397, 0x9908B0DF
    _F, _W = 1812433253, 32

    def __init__(self, seed: int):
        mask = (1 << self._W) - 1
        mt = [seed & mask]
        for i in range(1, self._N):
            prev = mt[-1]
            mt.append((self._F * (prev ^ (prev >> (self._W - 2))) + i) & mask)
        self._mt = mt
        self._idx = self._N

    def _twist(self):
        mt, N, M, A = self._mt, self._N, self._M, self._A
        upper, lower = 0x80000000, 0x7FFFFFFF
        for i in range(N):
            x = (mt[i] & upper) | (mt[(i + 1) % N] & lower)
            xa = x >> 1
            if x & 1:
                xa ^= A
            mt[i] = mt[(i + M) % N] ^ xa
        self._idx = 0

    def __call__(self) -> int:
        if self._idx >= self._N:
            self._twist()
        y = self._mt[self._idx]
        self._idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF


class _MT19937_64:
    """std::mt19937_64."""

    _N, _M, _A = 312, 156, 0xB5026F5AA96619E9
    _F, _W = 6364136223846793005, 64

    def __init__(self, seed: int):
        mask = (1 << self._W) - 1
        mt = [seed & mask]
        for i in range(1, self._N):
            prev = mt[-1]
            mt.append((self._F * (prev ^ (prev >> (self._W - 2))) + i) & mask)
        self._mt = mt
        self._idx = self._N

    def _twist(self):
        mt, N, M, A = self._mt, self._N, self._M, self._A
        upper = 0xFFFFFFFF80000000
        lower = 0x7FFFFFFF
        for i in range(N):
            x = (mt[i] & upper) | (mt[(i + 1) % N] & lower)
            xa = x >> 1
            if x & 1:
                xa ^= A
            mt[i] = mt[(i + M) % N] ^ xa
        self._idx = 0

    def __call__(self) -> int:
        if self._idx >= self._N:
            self._twist()
        y = self._mt[self._idx]
        self._idx += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        y ^= y >> 43
        return y & 0xFFFFFFFFFFFFFFFF


def _target_sample_len(short_seq_ratio, max_length, gen) -> int:
    if short_seq_ratio == 0:
        return max_length
    r = gen()
    if r % short_seq_ratio == 0:
        return 2 + r % (max_length - 1)
    return max_length


def _shuffle_rows(out: np.ndarray, seed: int) -> None:
    """The C++ original's Fisher-Yates over rows on std::mt19937_64."""
    gen = _MT19937_64(seed)
    for i in range(len(out) - 1, 0, -1):
        j = gen() % (i + 1)
        tmp = out[i].copy()
        out[i] = out[j]
        out[j] = tmp


def build_mapping(
    docs: np.ndarray, sizes: np.ndarray, num_epochs: int,
    max_num_samples: int, max_seq_length: int, short_seq_prob: float,
    seed: int, min_num_sent: int = 2,
) -> np.ndarray:
    """BERT-style sentence-group sample map: int64 rows (sentence_start,
    sentence_end, target_seq_length), shuffled. Documents with a sentence
    longer than 512 tokens or fewer than ``min_num_sent`` sentences are
    skipped; the sample cap applies at epoch boundaries only (the last
    epoch may overshoot)."""
    docs = np.ascontiguousarray(docs, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    short_seq_ratio = (int(round(1.0 / short_seq_prob))
                       if short_seq_prob > 0 else 0)
    gen = _MT19937(seed)
    rows = []
    for _ in range(num_epochs):
        if len(rows) >= max_num_samples:
            break
        for d in range(len(docs) - 1):
            first, last = int(docs[d]), int(docs[d + 1])
            remain = last - first
            if remain > 1 and (sizes[first:last] > _LONG_SENTENCE_LEN).any():
                continue
            if remain < min_num_sent:
                continue
            prev_start = first
            seq_len = num_sent = 0
            target = _target_sample_len(short_seq_ratio, max_seq_length, gen)
            for s in range(first, last):
                seq_len += int(sizes[s])
                num_sent += 1
                remain -= 1
                if ((seq_len >= target and remain > 1
                     and num_sent >= min_num_sent) or remain == 0):
                    rows.append((prev_start, s + 1, target))
                    prev_start = s + 1
                    target = _target_sample_len(
                        short_seq_ratio, max_seq_length, gen)
                    seq_len = num_sent = 0
    out = np.asarray(rows, np.int64).reshape(len(rows), 3)
    _shuffle_rows(out, seed + 1)
    return out


def build_blocks_mapping(
    docs: np.ndarray, sizes: np.ndarray, titles_sizes: np.ndarray,
    num_epochs: int, max_num_samples: int, max_seq_length: int,
    seed: int, use_one_sent_blocks: bool = False,
) -> np.ndarray:
    """ICT-style block map: int64 rows (sentence_start, sentence_end, doc,
    block_id), shuffled; a document's target length is max_seq_length -
    titles_sizes[doc], and block ids restart each epoch."""
    docs = np.ascontiguousarray(docs, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    titles_sizes = np.ascontiguousarray(titles_sizes, dtype=np.int32)
    min_num_sent = 1 if use_one_sent_blocks else 2
    rows = []
    for _ in range(num_epochs):
        block_id = 0
        if len(rows) >= max_num_samples:
            break
        for d in range(len(docs) - 1):
            first, last = int(docs[d]), int(docs[d + 1])
            target = max_seq_length - int(titles_sizes[d])
            remain = last - first
            if remain < min_num_sent:
                continue
            if (sizes[first:last] > _LONG_SENTENCE_LEN).any():
                continue
            prev_start = first
            seq_len = num_sent = 0
            for s in range(first, last):
                seq_len += int(sizes[s])
                num_sent += 1
                remain -= 1
                if ((seq_len >= target and remain >= min_num_sent
                     and num_sent >= min_num_sent) or remain == 0):
                    rows.append((prev_start, s + 1, d, block_id))
                    block_id += 1
                    prev_start = s + 1
                    seq_len = num_sent = 0
    out = np.asarray(rows, np.int64).reshape(len(rows), 4)
    _shuffle_rows(out, seed + 1)
    return out


if __name__ == "__main__":
    # The blending index's build time at a run's size, the C loop and its
    # plain version (the C library built first, outside the timing):
    #   python -m bdm_db1_tpu_torch.data.native [size] [weight ...]
    import sys
    import time

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10_240_000
    w = np.asarray([float(x) for x in sys.argv[2:]] or [0.5, 0.5])
    _blend_lib()
    for fn in (build_blending_indices, build_blending_indices_plain):
        t0 = time.perf_counter()
        fn(w / w.sum(), n)
        print(f"{fn.__name__}: {n} entries over {len(w)} datasets in "
              f"{time.perf_counter() - t0:.3f} s")
