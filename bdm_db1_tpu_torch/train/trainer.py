"""Training driver and validation loss (counterpart of
bdm_db1_tpu/train/trainer.py): loader batches to typed device batches, the
``Trainer`` loop (train step, logging of loss and tokens/sec per window,
the ``eval_fn`` hook, checkpointing with auto-resume and an emergency
checkpoint on a crash) and the mean masked CE over held-out batches that
the trainer logs every eval tick. Under a process group (data
parallelism) each rank's loader hands it its shard of the global batch;
the rates count the global batch and the losses are the global ones. A
tensor-parallel model (``model.tp``) counts over its data group: the
ranks of a model group read, count and draw the same rows; so does a
pipeline stage (``model.pp``), whose validation loss runs through the
stages."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from bdm_db1_tpu_torch.core.config import DB1Config
from bdm_db1_tpu_torch.core.logging import MetricLogger, print_rank_0
from bdm_db1_tpu_torch.data.input_specs import (
    ICTaskBatch, NLPTaskBatch, RLTaskBatch, VQATaskBatch,
)
from bdm_db1_tpu_torch.parallel.distributed import (
    barrier, rank_and_world, summed, world_group,
)
from bdm_db1_tpu_torch.parallel.mesh import batch_sharding, data_axis
from bdm_db1_tpu_torch.parallel.pipeline import pipelined_loss
from bdm_db1_tpu_torch.train.checkpoint import CheckpointManager
from bdm_db1_tpu_torch.train.step import make_train_rng

_BATCH_TYPES = {"rl": RLTaskBatch, "nlp": NLPTaskBatch, "ic": ICTaskBatch,
                "vqa": VQATaskBatch}


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
    bookkeeping: ``img_id``, ``ques_id``, ...) are dropped; a sub-modality
    group ("rl_img") takes its base modality's type."""
    dev = _check_device(device)
    out = {}
    for m, fields in raw.items():
        cls = _BATCH_TYPES.get(m.split("_")[0])
        if cls is None:
            raise ValueError(f"unknown modality group {m!r}; the groups are "
                             f"{tuple(_BATCH_TYPES)} and their "
                             "'<group>_<suffix>' sub-groups")
        valid = {f.name for f in dataclasses.fields(cls)}
        out[m] = cls(**{k: torch.as_tensor(np.asarray(v), device=dev)
                        for k, v in fields.items() if k in valid})
    return out


class Trainer:
    """The training loop over ``loader`` (numpy batches with [accum, micro,
    ...] fields): ``step_fn(state, batch, generator)`` per iteration, one
    seeded ``torch.Generator`` on the model's device for the dropout masks
    (``state.generator``), every ``log_interval`` iterations a host read of
    the loss and the tokens/sec of the window, every ``eval_interval`` the
    ``eval_fn(state, iteration)`` hook. Under a process group the
    generator is seeded by (``train.seed``, data rank), and by the stage
    too on a pipeline stage after the first, and tokens/sec counts the
    global batch (this rank's times the data-parallel size); the data
    rank is the world rank without tensor or pipeline parallelism.

    With ``cfg.train.save_dir``: metrics go to ``<save_dir>/metrics.jsonl``
    (unless a ``logger`` is given); the run resumes from the latest
    checkpoint there (model, optimizer, step, generator; the data stream
    starts again from the loader's beginning, as in the JAX package),
    saves every ``save_interval`` iterations and at the end, and on any
    exception saves an emergency checkpoint at the current step before
    raising. ``load_dir`` is not read here (evaluate_rl reads it).

    In a world of several processes the ranks meet at a barrier after the
    eval hook (which may run on rank 0 alone), and an exception raises at
    once, without the emergency checkpoint: the save is collective, and
    an exception on one rank finds the others inside a step, whose next
    collective then raises on them too."""

    def __init__(self, cfg: DB1Config, model, step_fn: Callable, state,
                 loader: Iterable, *, eval_fn: Optional[Callable] = None,
                 logger: Optional[MetricLogger] = None):
        self.cfg = cfg
        self.model = model
        self.step_fn = step_fn
        self.state = state
        self.loader = loader
        self.eval_fn = eval_fn
        self.logger = logger or MetricLogger(cfg.train.save_dir)
        self.ckpt = (CheckpointManager(cfg.train.save_dir)
                     if cfg.train.save_dir else None)

    def maybe_resume(self) -> int:
        """Restore the latest checkpoint into the state; the iteration to
        go on from (0 without one)."""
        if self.ckpt is None:
            return 0
        restored, client = self.ckpt.restore(self.state)
        if restored is None:
            return 0
        self.state = restored
        it = int(client["iteration"]) if client else int(restored.step)
        print_rank_0(f"resumed from checkpoint at iteration {it}")
        return it

    def train(self) -> None:
        """Run the loop; on any exception, save an emergency checkpoint
        first (when checkpointing, in one process), then raise."""
        try:
            self._train_loop()
        except BaseException:
            step = int(self.state.step)
            world = rank_and_world()[1]
            if self.ckpt is None or world > 1:
                print_rank_0(f"training interrupted at step {step}"
                             + (f"; no emergency checkpoint in a world of "
                                f"{world} processes" if self.ckpt else ""))
            else:
                print_rank_0(f"training interrupted — saving emergency "
                             f"checkpoint at iteration {step}")
                try:
                    self.ckpt.save(step, self.state,
                                   client_state={"iteration": step,
                                                 "emergency": True})
                    self.ckpt.wait()
                except Exception as e:  # keep the original traceback primary
                    print_rank_0(f"emergency checkpoint failed: {e}")
            raise

    def _train_loop(self) -> None:
        tcfg = self.cfg.train
        dev = self.model.device
        rank, world = batch_sharding(data_axis(self.model.tp,
                                               self.model.pp))
        if self.state.generator is None:
            pp = getattr(self.model, "pp", None)
            self.state.generator = make_train_rng(
                tcfg.seed, dev, rank, 0 if pp is None else pp.stage)
        iteration = self.maybe_resume()
        data_iter = iter(self.loader)
        tokens_per_batch = None
        t_window = time.perf_counter()
        window_iters = 0

        while iteration < tcfg.train_iters:
            batch = to_gato_batch(next(data_iter), dev)
            if tokens_per_batch is None:
                # every group's rows are L positions long (captioning and
                # VQA rows too, which the JAX Trainer leaves out)
                tokens_per_batch = world * sum(int(v.label.numel())
                                               for v in batch.values())
            self.state, metrics = self.step_fn(self.state, batch,
                                               self.state.generator)
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
                barrier()

            if self.ckpt and iteration % tcfg.save_interval == 0:
                self.ckpt.save(iteration, self.state,
                               client_state={"iteration": iteration})

        if self.ckpt:
            self.ckpt.save(tcfg.train_iters, self.state,
                           client_state={"iteration": tcfg.train_iters})
            self.ckpt.wait()
        self.logger.close()


def evaluate_loss(model, batches: Iterable, device="cuda") -> float:
    """Mean masked CE over held-out batches, each
    ``{modality: {field: [accum, micro, ...]}}``: one loss-only forward
    (``compute_loss=True, deterministic=True, loss_only=True``) per
    ``[micro, ...]`` slice, under ``torch.inference_mode()``, with one host
    read at the end. ``model`` must live on ``device``; NaN without
    batches. Under a process group each rank passes its shard of every
    micro-batch: a slice's loss
    is the masked mean over the global micro-batch, as in the train step
    (the count summed over the ranks, then the rank shares); a
    tensor-parallel model's ranks sum over its data group, and a pipeline
    stage runs each slice through the stages (parallel/pipeline.py
    ``pipelined_loss``) and sums over its data group."""
    dev = _check_device(device)
    if model.device != dev and not (
            dev.index is None and model.device.type == dev.type):
        raise ValueError(f"the model is on {model.device}, not {dev}")
    axis = data_axis(model.tp, model.pp)
    grp = world_group() if axis is None else axis.data_group
    count_reduce = None if grp is None else lambda c: summed(c, grp)
    losses = []
    with torch.inference_mode():
        for raw in batches:
            accum = len(next(iter(next(iter(raw.values())).values())))
            for a in range(accum):
                sub = to_gato_batch({m: {k: v[a] for k, v in fields.items()}
                                     for m, fields in raw.items()}, dev)
                if getattr(model, "pp", None) is not None:
                    loss = pipelined_loss(model, sub, count_reduce)
                else:
                    _, loss = model(sub, compute_loss=True,
                                    deterministic=True, loss_only=True,
                                    count_reduce=count_reduce)
                losses.append(loss)
        if not losses:
            return float("nan")
        losses = torch.stack(losses)
        if grp is not None:
            losses = summed(losses, grp)
        return float(losses.mean())
