"""Dataset split helper (copy of ``get_train_valid_test_split_`` from
bdm_db1_tpu/data/dataset_utils.py)."""

from __future__ import annotations

from typing import List


def get_train_valid_test_split_(splits_string: str, size: int) -> List[int]:
    """'90,5,5'-style split boundaries [0, train_end, valid_end, size] over
    ``size`` items."""
    splits = [float(s) for s in splits_string.split(",")]
    while len(splits) < 3:
        splits.append(0.0)
    splits = splits[:3]
    total = sum(splits)
    assert total > 0
    splits = [s / total for s in splits]
    index = [0]
    for s in splits:
        index.append(index[-1] + int(round(s * float(size))))
    diff = index[-1] - size
    index = [max(0, i - diff) if n == 3 else i for n, i in enumerate(index)]
    index[-1] = size
    return index
