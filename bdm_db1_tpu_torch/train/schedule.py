"""Learning-rate and weight-decay schedules (counterpart of
bdm_db1_tpu/train/schedule.py): linear warmup then {constant | linear |
cosine | inverse-square-root} decay to ``min_lr``, and a weight decay moved
{constant | linear | cosine} from ``start_weight_decay`` to
``end_weight_decay``. Each is a function of the step count that returns a
float computed in f32, as the JAX schedules compute it inside the update.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from bdm_db1_tpu_torch.core.config import OptimizerConfig

Schedule = Callable[[int], float]
f32 = np.float32


def lr_schedule(cfg: OptimizerConfig, train_iters: int) -> Schedule:
    warmup = cfg.lr_warmup_iters
    if cfg.lr_warmup_fraction is not None:
        warmup = int(cfg.lr_warmup_fraction * train_iters)
    decay_iters = cfg.lr_decay_iters or train_iters
    max_lr, min_lr = f32(cfg.lr), f32(cfg.min_lr)
    delta = f32(cfg.lr - cfg.min_lr)
    style = cfg.lr_decay_style
    if style not in ("constant", "linear", "cosine", "inverse-square-root"):
        raise ValueError(f"unknown lr decay style {style!r}")

    def schedule(step: int) -> float:
        step = f32(step)
        if warmup > 0 and step < warmup:
            return float(max_lr * step / f32(max(warmup, 1)))
        frac = np.clip((step - f32(warmup)) / f32(max(decay_iters - warmup, 1)),
                       f32(0.0), f32(1.0))
        if style == "constant":
            return float(max_lr)
        if style == "linear":
            return float(min_lr + delta * (f32(1.0) - frac))
        if style == "cosine":
            return float(min_lr + delta * f32(0.5)
                         * (np.cos(f32(math.pi) * frac) + f32(1.0)))
        s = max(step, f32(1.0))
        return float(min(max_lr, max_lr * np.sqrt(f32(max(warmup, 1)) / s)))

    return schedule


def wd_schedule(cfg: OptimizerConfig, train_iters: int) -> Schedule:
    start, end = f32(cfg.start_weight_decay), f32(cfg.end_weight_decay)
    diff = f32(cfg.end_weight_decay - cfg.start_weight_decay)
    style = cfg.weight_decay_incr_style
    if style == "constant" or cfg.start_weight_decay == cfg.end_weight_decay:
        return lambda step: float(end)
    if style not in ("linear", "cosine"):
        raise ValueError(f"unknown wd incr style {style!r}")

    def schedule(step: int) -> float:
        frac = np.clip(f32(step) / f32(max(train_iters, 1)), f32(0.0),
                       f32(1.0))
        if style == "linear":
            return float(start + frac * diff)
        return float(start + f32(0.5) * diff
                     * (f32(1.0) - np.cos(f32(math.pi) * frac)))

    return schedule
