"""Training driver and validation loss (counterpart of
bdm_db1_tpu/train/trainer.py): loader batches to typed device batches, the
``Trainer`` loop (train step, logging of loss and tokens/sec per window,
the ``eval_fn`` hook) and the mean masked CE over held-out batches that the
trainer logs every eval tick. Checkpointing (and so resume and the
emergency checkpoint) is not ported yet: a ``save_dir`` raises."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from bdm_db1_tpu_torch.core.config import DB1Config
from bdm_db1_tpu_torch.core.logging import MetricLogger, print_rank_0
from bdm_db1_tpu_torch.data.input_specs import RLTaskBatch
from bdm_db1_tpu_torch.train.step import make_train_rng

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


class Trainer:
    """The training loop over ``loader`` (numpy batches with [accum, micro,
    ...] fields): ``step_fn(state, batch, generator)`` per iteration, one
    seeded ``torch.Generator`` on the model's device for the dropout masks,
    every ``log_interval`` iterations a host read of the loss and the
    tokens/sec of the window, every ``eval_interval`` the ``eval_fn(state,
    iteration)`` hook."""

    def __init__(self, cfg: DB1Config, model, step_fn: Callable, state,
                 loader: Iterable, *, eval_fn: Optional[Callable] = None,
                 logger: Optional[MetricLogger] = None):
        if cfg.train.save_dir or cfg.train.load_dir:
            raise NotImplementedError(
                "checkpointing (save_dir/load_dir) is not ported yet")
        self.cfg = cfg
        self.model = model
        self.step_fn = step_fn
        self.state = state
        self.loader = loader
        self.eval_fn = eval_fn
        self.logger = logger or MetricLogger()

    def train(self) -> None:
        """Run the loop. Without checkpointing there is no emergency
        checkpoint to save: an interruption is reported with its iteration
        and raised."""
        try:
            self._train_loop()
        except BaseException:
            print_rank_0(f"training interrupted at step {self.state.step}")
            raise

    def _train_loop(self) -> None:
        tcfg = self.cfg.train
        iteration = 0
        dev = self.model.device
        gen = make_train_rng(tcfg.seed, dev)
        data_iter = iter(self.loader)
        tokens_per_batch = None
        t_window = time.perf_counter()
        window_iters = 0

        while iteration < tcfg.train_iters:
            batch = to_gato_batch(next(data_iter), dev)
            if tokens_per_batch is None:
                tokens_per_batch = sum(int(v.tokens.numel())
                                       for v in batch.values())
            self.state, metrics = self.step_fn(self.state, batch, gen)
            iteration += 1
            window_iters += 1

            if iteration % tcfg.log_interval == 0:
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t_window
                tps = tokens_per_batch * window_iters / max(dt, 1e-9)
                scalars = {"loss": loss, "tokens_per_sec": tps}
                if "grad_norm" in metrics:
                    scalars["grad_norm"] = float(metrics["grad_norm"])
                self.logger.log(iteration, scalars, prefix="train/")
                print_rank_0(f"iter {iteration} | loss {loss:.4f} | "
                             f"{tps:,.0f} tok/s")
                t_window = time.perf_counter()
                window_iters = 0

            if self.eval_fn and iteration % tcfg.eval_interval == 0:
                eval_metrics = self.eval_fn(self.state, iteration)
                if eval_metrics:
                    self.logger.log(iteration, eval_metrics, prefix="valid/")
        self.logger.close()


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
