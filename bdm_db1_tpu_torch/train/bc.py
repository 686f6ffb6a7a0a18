"""Behaviour cloning on an env's expert data, a few-shot finetune
(counterpart of bdm_db1_tpu/train/bc.py).

Packs expert trajectories of an ``RLFullDataset`` into training rows and
runs a handful of AdamW steps on a model. A policy cloned from a smooth
expert is what a speculative-decode measurement needs: random weights
reject every guess and zeroed weights accept every one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bdm_db1_tpu_torch.core.config import OptimizerConfig
from bdm_db1_tpu_torch.train.step import init_train_state, make_train_step
from bdm_db1_tpu_torch.train.trainer import to_gato_batch

# the JAX package turns rematerialization on from this depth on
REMAT_LAYERS = 24


def pack_bc_batch(ds, sample_ids, micro: int):
    """``micro`` dataset rows per batch, as [accum = 1, micro, L] fields of
    one "rl" group (``to_gato_batch``'s layout); RL rows without images."""
    rows = [ds.get(int(i)) for i in sample_ids]
    if len(rows) % micro:
        raise ValueError(f"{len(rows)} rows do not split into batches of "
                         f"{micro}")
    out = []
    for b0 in range(0, len(rows), micro):
        grp = rows[b0:b0 + micro]
        out.append({"rl": {
            k: np.stack([r[k] for r in grp])[None]
            for k in ("tokens", "position_id", "loss_mask", "label")
        }})
    return out


def behavior_clone(cfg, model, ds, *, steps: int = 150, micro: int = 4,
                   lr: float = 1e-4, seed: int = 0,
                   distinct_batches: int = 8, log_every: int = 0,
                   remat: Optional[bool] = None):
    """Finetune ``model`` (a ``TransformerXL`` of ``cfg.model``, in place)
    by behaviour cloning on ``ds`` (the loss is action-masked by the
    packing) and return it: ``distinct_batches`` batches of ``micro`` rows
    drawn once with ``seed``, cycled for ``steps`` AdamW steps (cosine
    decay to lr / 10, warm-up steps / 10, no weight decay), dropout on.

    Remat (the model's ``remat_policy``) is on during the steps when
    ``remat`` says so, and by default at ``n_layer >= 24``, as in the JAX
    package; ``model.cfg.remat`` is put back afterwards."""
    if remat is None:
        remat = cfg.model.n_layer >= REMAT_LAYERS
    dev = model.device
    rng = np.random.RandomState(seed)
    n_rows = distinct_batches * micro
    sample_ids = rng.choice(len(ds), size=n_rows, replace=len(ds) < n_rows)
    batches = [to_gato_batch(b, dev)
               for b in pack_bc_batch(ds, sample_ids, micro)]

    opt = OptimizerConfig(lr=lr, min_lr=lr * 0.1, weight_decay=0.0,
                          lr_warmup_iters=max(1, steps // 10),
                          lr_decay_style="cosine")
    state = init_train_state(model, opt, steps)
    step_fn = make_train_step(model)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    was = model.cfg.remat
    model.cfg.remat = bool(remat)
    try:
        for i in range(steps):
            state, metrics = step_fn(state, batches[i % len(batches)], gen)
            if log_every and (i % log_every == 0 or i == steps - 1):
                print(f"  bc step {i}: loss {float(metrics['loss']):.4f}",
                      flush=True)
    finally:
        model.cfg.remat = was
    return state.model
