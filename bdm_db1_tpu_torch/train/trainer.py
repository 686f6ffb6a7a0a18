"""Validation loss (the evaluation half of bdm_db1_tpu/train/trainer.py):
loader batches to typed device batches, and the mean masked CE over
held-out batches that the trainer logs every eval tick. The training loop,
checkpointing and the train step come with the training slice."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import numpy as np
import torch

from bdm_db1_tpu_torch.data.input_specs import RLTaskBatch

_BATCH_TYPES = {"rl": RLTaskBatch}


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return dev


def to_gato_batch(raw: Dict[str, Dict[str, np.ndarray]],
                  device="cuda") -> Dict[str, object]:
    """Loader output {modality: {field: array}} -> {modality: typed batch}
    with tensors on ``device``. Fields the batch type does not have (host
    bookkeeping) are dropped; a sub-modality group ("rl_img") takes its
    base modality's type. Only RL batches are ported."""
    dev = _check_device(device)
    out = {}
    for m, fields in raw.items():
        cls = _BATCH_TYPES.get(m.split("_")[0])
        if cls is None:
            raise NotImplementedError(
                f"modality group {m!r}: only RL batches are ported")
        valid = {f.name for f in dataclasses.fields(cls)}
        out[m] = cls(**{k: torch.as_tensor(np.asarray(v), device=dev)
                        for k, v in fields.items() if k in valid})
    return out


def evaluate_loss(model, batches: Iterable, device="cuda") -> float:
    """Mean masked CE over held-out batches, each
    ``{modality: {field: [accum, micro, ...]}}``: one loss-only forward
    (``compute_loss=True, deterministic=True, loss_only=True``) per
    ``[micro, ...]`` slice, under ``torch.inference_mode()``, with one host
    read at the end. ``model`` must live on ``device``; NaN without
    batches."""
    dev = _check_device(device)
    if model.device != dev and not (
            dev.index is None and model.device.type == dev.type):
        raise ValueError(f"the model is on {model.device}, not {dev}")
    losses = []
    with torch.inference_mode():
        for raw in batches:
            accum = len(next(iter(next(iter(raw.values())).values())))
            for a in range(accum):
                sub = {m: {k: v[a] for k, v in fields.items()}
                       for m, fields in raw.items()}
                _, loss = model(to_gato_batch(sub, dev), compute_loss=True,
                                deterministic=True, loss_only=True)
                losses.append(loss)
        if not losses:
            return float("nan")
        return float(torch.stack(losses).mean())
