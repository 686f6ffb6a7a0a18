"""Rank-0 printing and the scalar sink of the trainer (counterpart of
bdm_db1_tpu/core/logging.py): console, ``metrics.jsonl`` and TensorBoard
when it is installed. The rank is ``torch.distributed``'s when a process
group is up, else 0."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import torch.distributed as dist


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def is_main_process() -> bool:
    return process_index() == 0


def print_rank_0(*args, **kwargs) -> None:
    if is_main_process():
        print(*args, **kwargs)
        sys.stdout.flush()


class MetricLogger:
    """Scalar sink: console + metrics.jsonl + optional TensorBoard."""

    def __init__(self, log_dir: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None):
        self._jsonl = None
        self._tb = None
        if not is_main_process():
            return
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                print_rank_0("tensorboard unavailable; skipping TB logging")

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = "") -> None:
        if not is_main_process():
            return
        record = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}"
            record[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), int(step))
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
