"""Partitioning arithmetic (counterpart of bdm_db1_tpu/parallel/utils.py, a
copy in numpy): the reference's ``VocabUtility`` and
``split_tensor_along_last_dim`` for tools that need explicit shard math."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def divide(numerator: int, denominator: int) -> int:
    assert numerator % denominator == 0, (numerator, denominator)
    return numerator // denominator


def vocab_range_from_per_partition_size(
    per_partition_size: int, rank: int
) -> Tuple[int, int]:
    lo = rank * per_partition_size
    return lo, lo + per_partition_size


def vocab_range_from_global_vocab_size(
    global_vocab_size: int, rank: int, world_size: int
) -> Tuple[int, int]:
    per = divide(global_vocab_size, world_size)
    return vocab_range_from_per_partition_size(per, rank)


def split_along_last_dim(array: np.ndarray, num_partitions: int):
    """Even split of the last dimension into ``num_partitions`` views."""
    per = divide(array.shape[-1], num_partitions)
    return tuple(
        array[..., i * per: (i + 1) * per] for i in range(num_partitions)
    )
