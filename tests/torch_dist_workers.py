"""Worlds of processes for the port's data-parallel tests.

:class:`World` starts ``world`` processes by the spawn method, joins them
in a gloo process group over a ``file://`` store under the test's own
directory (so xdist workers never race for a port) and runs one of the
functions below in each, as ``fn(rank, world, *args)``; the arguments go
to the processes, and each result comes back, through ``torch.save``
files. A test starts its worlds first and computes the JAX package's side
while they run. This module imports torch and the port only: a process of a world
starts without JAX.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import time
import traceback
import uuid

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD_TIMEOUT_S = 120


class World:
    """``world`` processes started by the spawn method, each running
    ``fn(rank, world, *args)`` in one gloo world; :meth:`join` waits for
    them (at most ``WORLD_TIMEOUT_S``) and returns their results in rank
    order, or raises with the first failing rank's traceback."""

    def __init__(self, fn, world: int, tmp_path, *args):
        self.work = os.path.join(str(tmp_path),
                                 f"world-{uuid.uuid4().hex[:8]}")
        os.makedirs(self.work)
        torch.save(args, os.path.join(self.work, "args.pt"))
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_child,
                                  args=(fn, rank, world, self.work))
                      for rank in range(world)]
        for p in self.procs:
            p.start()
        self.results = None

    def join(self):
        if self.results is not None:
            return self.results
        for p in self.procs:
            p.join(WORLD_TIMEOUT_S)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        n = len(self.procs)
        errs = [os.path.join(self.work, f"{r}.err") for r in range(n)]
        errors = [open(e).read() for e in errs if os.path.exists(e)]
        if errors:
            raise RuntimeError(errors[0])
        codes = [p.exitcode for p in self.procs]
        if any(codes):
            raise RuntimeError(f"a rank of the world failed: exit codes "
                               f"{codes}")
        self.results = [torch.load(os.path.join(self.work, f"{r}.pt"),
                                   weights_only=False) for r in range(n)]
        return self.results


def _child(fn, rank: int, world: int, work: str) -> None:
    torch.set_num_threads(1)
    try:
        args = torch.load(os.path.join(work, "args.pt"), weights_only=False)
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(work, 'store')}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(work, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(work, f"{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---- shared set-up ----------------------------------------------------------

def tiny_model(state_dict, **overrides):
    """The port's db1_tiny in f32 on the CPU holding ``state_dict``."""
    from bdm_db1_tpu_torch.core.config import db1_tiny
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL

    cfg = db1_tiny(dtype="float32", **overrides)
    model = TransformerXL(cfg.model, cfg.vocab, device="cpu")
    model.load_state_dict(state_dict)
    return model


def shard(raw, rank: int, world: int):
    """This rank's rows of a loader batch {group: {field: [accum, micro,
    ...]}}: a contiguous block of the micro axis."""
    out = {}
    for m, fields in raw.items():
        n = next(iter(fields.values())).shape[1] // world
        out[m] = {k: v[:, rank * n:(rank + 1) * n] for k, v in fields.items()}
    return out


class FixedLoader:
    """The same batch every time."""

    def __init__(self, raw):
        self.raw = raw

    def __iter__(self):
        return self

    def __next__(self):
        return self.raw


class FailingLoader(FixedLoader):
    """The same batch, and a ``RuntimeError`` in place of the
    ``fail_at``-th (never with None)."""

    def __init__(self, raw, fail_at=None):
        super().__init__(raw)
        self.fail_at, self.n = fail_at, 0

    def __next__(self):
        self.n += 1
        if self.n == self.fail_at:
            raise RuntimeError(f"the loader failed at batch {self.n}")
        return self.raw


def train_leaves(state) -> dict:
    """Copies of the parameters, the moments and the generator state."""
    opt = state.optimizer.state_dict()
    out = {f"model.{n}": p.detach().clone()
           for n, p in state.model.named_parameters()}
    for key in ("mu", "nu"):
        out.update({f"{key}.{n}": t.clone() for n, t in opt[key].items()})
    out["generator"] = state.generator.get_state()
    return out


# ---- the functions a world runs ---------------------------------------------

def dp_step(rank, world, state_dict, raw, opt_kw, overrides):
    """One ``make_train_step`` step (with its grad norm) on this rank's
    shard of ``raw``; then, with dropout 0.1, the first dropout mask of
    the rank's training generator (``make_train_rng(seed 0, rank)``)."""
    from bdm_db1_tpu_torch.ops.fast_dropout import dropout
    from bdm_db1_tpu_torch.train import step as tstep

    model = tiny_model(state_dict, **overrides)
    out = one_step(model, shard(raw, rank, world), opt_kw)
    out["dropout_mask"] = dropout(torch.ones(64, 64), 0.1,
                                  tstep.make_train_rng(0, "cpu", rank)) != 0
    return out


def one_step(model, raw, opt_kw) -> dict:
    """One ``make_train_step`` step of ``model`` on ``raw`` with the
    optimizer of ``opt_kw`` (20 iterations): the loss, the grad norm, the
    gradients the optimizer was handed and the parameters after."""
    from bdm_db1_tpu_torch.core.config import OptimizerConfig
    from bdm_db1_tpu_torch.train import step as tstep
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    state = tstep.init_train_state(model, OptimizerConfig(**opt_kw), 20)
    grads = {}
    opt_step = state.optimizer.step

    def keeping():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        opt_step()

    state.optimizer.step = keeping
    step = tstep.make_train_step(model, with_grad_norm=True)
    state, met = step(state, to_gato_batch(raw, "cpu"), torch.Generator())
    return {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "grads": grads, "params": {n: p.detach().clone()
                                       for n, p in model.named_parameters()}}


def trainer_run(rank, world, state_dict, raw, cfg, resume_from=None):
    """``Trainer.train()`` over this rank's shard of ``raw`` (the same
    batch each iteration), resuming from ``cfg.train.save_dir`` when it
    holds a checkpoint; the final leaves, the step and each step's loss.
    ``resume_from``: a step directory of another run, copied into
    ``cfg.train.save_dir`` first, once it exists (that run may still be
    going: a finished step appears by a rename)."""
    from bdm_db1_tpu_torch.train import step as tstep
    from bdm_db1_tpu_torch.train.trainer import Trainer

    if resume_from is not None:
        if rank == 0:
            deadline = time.monotonic() + WORLD_TIMEOUT_S
            while not os.path.isdir(resume_from):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{resume_from} never appeared")
                time.sleep(0.05)
            shutil.copytree(resume_from, os.path.join(
                cfg.train.save_dir, os.path.basename(resume_from)))
        dist.barrier()
    model = tiny_model(state_dict)
    state = tstep.init_train_state(model, cfg.train.optimizer,
                                   cfg.train.train_iters)
    step = tstep.make_train_step(model)
    losses = []

    def recording(st, batch, gen):
        st, met = step(st, batch, gen)
        losses.append(float(met["loss"]))
        return st, met

    trainer = Trainer(cfg, model, recording, state,
                      FixedLoader(shard(raw, rank, world)))
    trainer.train()
    return {"leaves": train_leaves(trainer.state),
            "step": trainer.state.step, "losses": losses}


def trainer_fails(rank, world, state_dict, raw, cfg):
    """``Trainer.train()`` over this rank's shard of ``raw`` whose loader
    fails on rank 1 at its second batch, while rank 0 goes on into step
    2: each rank's exception, the seconds until ``train`` raised, and the
    step it stopped at."""
    from bdm_db1_tpu_torch.train import step as tstep
    from bdm_db1_tpu_torch.train.trainer import Trainer

    model = tiny_model(state_dict)
    state = tstep.init_train_state(model, cfg.train.optimizer,
                                   cfg.train.train_iters)
    loader = FailingLoader(shard(raw, rank, world), 2 if rank == 1 else None)
    trainer = Trainer(cfg, model, tstep.make_train_step(model), state,
                      loader)
    t0 = time.monotonic()
    try:
        trainer.train()
        error = None
    except Exception as e:
        error = f"{type(e).__name__}: {e}"
    return {"error": error, "seconds": time.monotonic() - t0,
            "step": trainer.state.step}


def mesh_groups(rank, world, mesh_kw):
    """``make_mesh`` of ``MeshConfig(**mesh_kw)`` on the CPU: its shape,
    dim names, and the size of each dim's group, with the "data" group's
    sum of the ranks."""
    from bdm_db1_tpu_torch.core.config import MeshConfig
    from bdm_db1_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(**mesh_kw), "cpu")
    ranks = torch.tensor([float(rank)])
    dist.all_reduce(ranks, group=mesh.get_group("data"))
    return {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "sizes": {n: dist.get_world_size(mesh.get_group(n))
                      for n in mesh.mesh_dim_names},
            "data_rank_sum": float(ranks)}


def evaluate_rl_main(rank, world, cfg, registered):
    """``evaluate_rl.main`` on the CPU after registering the envs
    ``registered`` ({name: FakeContinuousEnv kwargs}); its records and
    those of this rank's shard."""
    from bdm_db1_tpu_torch.eval import envs as te
    from bdm_db1_tpu_torch.eval import evaluate_rl
    from bdm_db1_tpu_torch.eval.harness import shard_envs

    for name, kw in registered.items():
        te.register_env(name, _FakeContinuous(kw))
    return {"records": evaluate_rl.main(cfg, device="cpu"),
            "shard": shard_envs(list(cfg.eval.env_names))}


def pretrain_main(rank, world, cfg):
    """``pretrain.main`` on the CPU; what it printed."""
    import contextlib
    import io

    from bdm_db1_tpu_torch.train import pretrain

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pretrain.main(cfg, device="cpu")
    return out.getvalue()


@dataclasses.dataclass
class _FakeContinuous:
    """A picklable env factory."""
    kw: dict

    def __call__(self):
        from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv

        return FakeContinuousEnv(**self.kw)


def numpy_batch(accum: int, micro: int, seq: int, seed: int,
                densities) -> dict:
    """An RL loader batch [accum, micro, seq] of db1_tiny's vocab whose row
    r keeps each position in its loss mask with probability
    ``densities[r]`` (so that shards can be given unequal counts)."""
    rng = np.random.RandomState(seed)
    shape = (accum, micro, seq)
    dens = np.asarray(densities, np.float64)[None, :, None]
    return {"rl": {
        "tokens": rng.randint(0, 321, shape).astype(np.int32),
        "position_id": rng.randint(0, 60, shape).astype(np.int32),
        "loss_mask": (rng.rand(*shape) < dens).astype(np.float32),
        "label": rng.randint(0, 321, shape).astype(np.int32)}}


# ---- tensor parallelism -----------------------------------------------------

def tp_of(mesh_kw, sequence_sharded: bool = False):
    """This process's ``TensorParallel`` in ``make_mesh(MeshConfig(
    **mesh_kw))`` on the CPU."""
    from bdm_db1_tpu_torch.core.config import MeshConfig
    from bdm_db1_tpu_torch.parallel.mesh import make_mesh, tensor_parallel

    return tensor_parallel(make_mesh(MeshConfig(**mesh_kw), "cpu"),
                           sequence_sharded)


def tp_model(state_dict, tp, **overrides):
    """The port's db1_tiny in f32 on the CPU holding this rank's shard of
    ``state_dict`` (a whole model's)."""
    from bdm_db1_tpu_torch.core.config import db1_tiny
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.train.convert import load_into

    cfg = db1_tiny(dtype="float32", **overrides)
    model = TransformerXL(cfg.model, cfg.vocab, device="cpu", tp=tp)
    load_into(model, state_dict)
    return model


def _gathered(tensors: dict, tp, cfg) -> dict:
    from bdm_db1_tpu_torch.parallel.mesh import gather_state_dict

    return gather_state_dict(tensors, tp, cfg)


def tp_step(rank, world, state_dict, raw, opt_kw, overrides, mesh_kw,
            sequence_sharded):
    """A tensor-parallel rank: the logits of its forward over the first
    micro-batch of its data shard of ``raw``, then one ``make_train_step``
    step; the loss, the grad norm, the gradients the optimizer was handed
    and the parameters after, both gathered whole; its mesh coordinates."""
    from bdm_db1_tpu_torch.core.config import OptimizerConfig
    from bdm_db1_tpu_torch.train import step as tstep
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    tp = tp_of(mesh_kw, sequence_sharded)
    model = tp_model(state_dict, tp, **overrides)
    whole = _gathered(model.state_dict(), tp, model.cfg)
    roundtrip = whole.keys() == state_dict.keys() and all(
        torch.equal(t, state_dict[n]) for n, t in whole.items())
    mine = shard(raw, tp.data_rank, tp.data_size)
    with torch.no_grad():
        logits, _ = model(to_gato_batch(
            {m: {k: v[0] for k, v in f.items()} for m, f in mine.items()},
            "cpu"))
    state = tstep.init_train_state(model, OptimizerConfig(**opt_kw), 20)
    grads = {}
    opt_step = state.optimizer.step

    def keeping():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        opt_step()

    state.optimizer.step = keeping
    step = tstep.make_train_step(model, with_grad_norm=True)
    state, met = step(state, to_gato_batch(mine, "cpu"), torch.Generator())
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return {"logits": logits, "loss": float(met["loss"]),
            "grad_norm": float(met["grad_norm"]),
            "grads": _gathered(grads, tp, model.cfg),
            "params": _gathered(params, tp, model.cfg),
            "coords": (tp.data_rank, tp.rank), "roundtrip": roundtrip}


def tp_ce(rank, world, h, emb, labels, mask, valid, mesh_kw):
    """The vocab-parallel fused CE of this rank's rows of ``emb``: the loss
    and the gradients of h (whole) and of the rows (gathered)."""
    from bdm_db1_tpu_torch.ops.fused_ce import masked_cross_entropy_fused
    from bdm_db1_tpu_torch.parallel.mesh import gather_tensor, shard_tensor

    tp = tp_of(mesh_kw)
    h = h.clone().requires_grad_(True)
    w = shard_tensor(emb, 0, 1, tp.rank, tp.size).requires_grad_(True)
    loss = masked_cross_entropy_fused(h, w, labels, mask, valid, tp=tp)
    loss.backward()
    return {"loss": float(loss), "dh": h.grad,
            "dw": gather_tensor(w.grad, (0, 1), tp), "rows": w.shape[0]}


def _count_checkpoint_gathers() -> list:
    """Count, in the returned list's one entry, the ``gather_tensor`` calls
    made from the checkpoint module's code (through the mesh module or a
    name the checkpoint module imported)."""
    import sys

    from bdm_db1_tpu_torch.parallel import mesh
    from bdm_db1_tpu_torch.train import checkpoint

    count = [0]
    real = mesh.gather_tensor

    def counting(*args, **kwargs):
        frame = sys._getframe(1)
        while frame is not None:
            if frame.f_globals.get("__name__") == checkpoint.__name__:
                count[0] += 1
                break
            frame = frame.f_back
        return real(*args, **kwargs)

    mesh.gather_tensor = counting
    if hasattr(checkpoint, "gather_tensor"):
        checkpoint.gather_tensor = counting
    return count


def tp_trainer(rank, world, state_dict, raw, cfg, mesh_kw):
    """``Trainer.train()`` of a tensor-parallel model over this rank's data
    shard of ``raw`` (the same batch each iteration), saving into
    ``cfg.train.save_dir``; then a fresh Trainer's ``maybe_resume``. Each
    step's loss, the replicated parameters (this rank's own) and the
    whole parameters after, the generator state and the resumed
    iteration; the checkpoint module's ``gather_tensor`` calls, the bytes
    of this rank's file of the last step, and the bytes of the sharded
    tensors the rank holds (its parameters' and moments' shards)."""
    from bdm_db1_tpu_torch.parallel.mesh import replicated, shard_rule
    from bdm_db1_tpu_torch.train import step as tstep
    from bdm_db1_tpu_torch.train.trainer import Trainer

    gathers = _count_checkpoint_gathers()
    tp = tp_of(mesh_kw)
    model = tp_model(state_dict, tp)
    state = tstep.init_train_state(model, cfg.train.optimizer,
                                   cfg.train.train_iters)
    step = tstep.make_train_step(model)
    losses = []

    def recording(st, batch, gen):
        st, met = step(st, batch, gen)
        losses.append(float(met["loss"]))
        return st, met

    loader = FixedLoader(shard(raw, tp.data_rank, tp.data_size))
    trainer = Trainer(cfg, model, recording, state, loader)
    trainer.train()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    fresh = Trainer(cfg, model, step, tstep.init_train_state(
        model, cfg.train.optimizer, cfg.train.train_iters), loader)
    resumed_at = fresh.maybe_resume()
    opt = trainer.state.optimizer.state_dict()
    shards = [t for n, t in model.state_dict().items()
              if shard_rule(n, model.cfg)]
    shards += [t for key in ("mu", "nu") for n, t in opt[key].items()
               if shard_rule(n, model.cfg)]
    last = os.path.join(cfg.train.save_dir, str(cfg.train.train_iters),
                        f"__{rank}_0.distcp")
    return {"losses": losses, "step": trainer.state.step,
            "checkpoint_gathers": gathers[0],
            "file_bytes": os.path.getsize(last),
            "shard_bytes": sum(t.numel() * t.element_size() for t in shards),
            "replicated": {n: p for n, p in params.items() if replicated(n)},
            "params": _gathered(params, tp, model.cfg),
            "generator": trainer.state.generator.get_state(),
            "resumed_at": resumed_at}


def _chain(decoder, primes, defer):
    """The greedy actions of ``decoder`` over the prime stream ``primes``
    (tests/test_speculative.py's ``_chain``)."""
    mems = decoder.init_mems(primes[0].shape[0])
    acts, deferred = [], None
    for p in primes:
        if defer:
            a, mems = decoder.decode(p, mems, deferred_tok=deferred,
                                     defer_last=True)
            deferred = np.asarray(a)[..., -decoder.defer_width:]
        else:
            a, mems = decoder.decode(p, mems)
        acts.append(np.asarray(a))
    return acts


def tp_chains(rank, world, state_dict, cases, mesh_kw):
    """Greedy chains of the sharded decode, one a case: (model overrides,
    obs length, action length, primes, defer). Each decoder is an
    ``ActionDecoder(mesh=...)`` over this rank's shard (its int8 weights,
    when the overrides ask for them, made after sharding, as
    ``build_decoder_for_env`` makes them); with the first case's cache
    shapes and the pool's sharing."""
    from bdm_db1_tpu_torch.core.config import MeshConfig, db1_tiny
    from bdm_db1_tpu_torch.eval.decode import (
        ActionDecoder, DecoderPool, shard_decode_params,
    )
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(**mesh_kw), "cpu")
    out = {"chains": [], "cache": None}
    for over, obs_len, act_len, primes, defer in cases:
        cfg = db1_tiny(dtype="float32", **over)
        full = TransformerXL(cfg.model, cfg.vocab, device="cpu")
        full.load_state_dict(state_dict)
        model = shard_decode_params(full, mesh)
        if cfg.model.decode_weight_dtype:
            model.quantize_decode_weights()
        dec = ActionDecoder(model, cfg.vocab.layout(), obs_len, act_len,
                            False, mesh=mesh)
        assert dec.model is model
        out["chains"].append(_chain(dec, primes, defer))
        if out["cache"] is None:
            mems = dec.init_mems(primes[0].shape[0])
            out["cache"] = {k: tuple(v.shape) for k, v in mems.items()
                            if k != "cursor"}
            out["speculates"] = dec.speculates
    pool = DecoderPool(full, mesh=mesh)
    out["pool_sharded"] = pool.model is not full and pool.model.tp is not None
    out["pool_heads"] = pool.model.heads
    return out


# ---- pipeline parallelism ---------------------------------------------------

def pp_of(mesh_kw):
    """(``TensorParallel`` or None, ``PipelineParallel``) of this process in
    ``make_mesh(MeshConfig(**mesh_kw))`` on the CPU."""
    from bdm_db1_tpu_torch.core.config import MeshConfig
    from bdm_db1_tpu_torch.parallel.mesh import (
        make_mesh, pipeline_parallel, tensor_parallel,
    )

    mc = MeshConfig(**mesh_kw)
    mesh = make_mesh(mc, "cpu")
    tp = tensor_parallel(mesh) if mc.model_parallel > 1 else None
    return tp, pipeline_parallel(mesh, mc.pipeline_microbatches)


def pp_model(state_dict, tp, pp, **overrides):
    """The port's db1_tiny in f32 on the CPU as this rank's stage (and
    tensor-parallel shard) of a whole model's ``state_dict``."""
    from bdm_db1_tpu_torch.core.config import db1_tiny
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.train.convert import load_into

    cfg = db1_tiny(dtype="float32", **overrides)
    model = TransformerXL(cfg.model, cfg.vocab, device="cpu", tp=tp, pp=pp)
    if state_dict is not None:
        load_into(model, state_dict)
    return model


def _first_micro(raw):
    return {m: {k: v[0] for k, v in f.items()} for m, f in raw.items()}


def pp_step(rank, world, state_dict, raw, opt_kw, overrides, mesh_kw,
            steps, ckpt_dir):
    """A pipeline rank: ``pipeline_trunk`` over the first micro-batch of
    ``raw`` (every row, in the mesh's pipeline micro-batches; the output
    on the last stage) and ``gather_stages`` (stage 0's whole state dict,
    gathered over the model group, and its parameter count), then ``steps`` ``make_train_step`` steps on its
    data shard of ``raw`` with the collective save of the last into
    ``ckpt_dir``: each step's loss and grad norm, the first step's
    gradients and the parameters after, both gathered over the model
    group, the layers the stage holds and its mesh coordinates."""
    from bdm_db1_tpu_torch.core.config import OptimizerConfig
    from bdm_db1_tpu_torch.parallel.pipeline import (
        gather_stages, pipeline_trunk,
    )
    from bdm_db1_tpu_torch.train import step as tstep
    from bdm_db1_tpu_torch.train.checkpoint import CheckpointManager
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    tp, pp = pp_of(mesh_kw)
    model = pp_model(state_dict, tp, pp, **overrides)
    whole = to_gato_batch(_first_micro(raw), "cpu")
    rows = whole["rl"].label.shape
    h = None
    if pp.first:
        with torch.no_grad():
            h = model.embed_concat(whole, with_targets=False)[0]
    trunk = pipeline_trunk(model, h, shape=rows)
    out = {"trunk": trunk, "stage": pp.stage, "coords": (
        pp.data_rank, pp.stage, 0 if tp is None else tp.rank),
        "layers": [int(n.split(".")[1]) for n, _ in model.named_parameters()
                   if n.endswith("qkv_net.weight")]}
    whole = gather_stages(model)
    out["gathered"] = out["gathered_params"] = None
    if whole is not None:
        sd = {n: t.clone() for n, t in whole.state_dict().items()}
        out["gathered"] = sd if tp is None else _gathered(sd, tp, model.cfg)
        out["gathered_params"] = len(list(whole.parameters()))
    if not steps:
        return out
    mine = to_gato_batch(shard(raw, pp.data_rank, pp.data_size), "cpu")
    state = tstep.init_train_state(model, OptimizerConfig(**opt_kw), 20)
    grads = {}
    opt_step = state.optimizer.step

    def keeping():
        if not grads:
            grads.update({n: p.grad.clone()
                          for n, p in model.named_parameters()
                          if p.grad is not None})
        opt_step()

    state.optimizer.step = keeping
    step = tstep.make_train_step(model, with_grad_norm=True)
    losses = []
    for _ in range(steps):
        state, met = step(state, mine, torch.Generator())
        losses.append((float(met["loss"]), float(met["grad_norm"])))
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(steps, state)
    mgr.wait()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    if tp is not None:
        grads = _gathered(grads, tp, model.cfg)
        params = _gathered(params, tp, model.cfg)
    out.update(losses=losses, grads=grads, params=params)
    return out


def _mask_fingerprints(calls):
    """A wrapper of ``dropout`` that records, for each call that drops, the
    bytes of its mask (where a nonzero input became 0)."""
    def wrap(fn):
        def recording(x, rate, generator, *a, **kw):
            y = fn(x, rate, generator, *a, **kw)
            if rate > 0:
                calls.append(((y == 0) & (x != 0)).numpy().tobytes())
            return y
        return recording
    return wrap


def pp_dropout(rank, world, state_dict, raw, const_raw, samples,
               mesh_kw):
    """A pipeline rank at pp 2 with dropout. (1) One pipelined step at the
    default rates of db1_tiny(n_layer=4), dropout 0.1: the dropped r each
    stage used and the fingerprints of its layers' masks. (2) ``samples``
    GPipe forwards of db1_tiny(n_layer=2) (dropout 0.2, no embedding
    dropout) over the first micro-batch of ``raw``, stage s drawing from
    ``make_train_rng(1000 + i, rank 0, stage s)``: the outputs on the last
    stage; rank 0 also the one-process trunk's over the same input
    (generator 5000 + i). (3) six steps with dropout 0.1 on
    ``const_raw`` at lr 1e-2: the losses and the replicated parameters
    after."""
    from bdm_db1_tpu_torch.core.config import OptimizerConfig, db1_tiny
    from bdm_db1_tpu_torch.models import transformer_xl as txl
    from bdm_db1_tpu_torch.parallel import pipeline
    from bdm_db1_tpu_torch.parallel.mesh import pipe_replicated
    from bdm_db1_tpu_torch.train import step as tstep
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    _, pp = pp_of(mesh_kw)
    drop = dict(drop=0.1, embd_pdrop=0.1, dropattn=0.0)
    model = pp_model(None, None, pp, n_layer=4, **drop)
    batch = to_gato_batch(raw, "cpu")
    masks, rs = [], []
    stage_inputs = pipeline._stage_inputs

    def keep_r(*a, **kw):
        out = stage_inputs(*a, **kw)
        rs.append(out[1].clone())
        return out

    plain = txl.dropout
    pipeline._stage_inputs = keep_r
    txl.dropout = _mask_fingerprints(masks)(plain)
    try:
        pipeline.make_pipelined_loss_fn(model)(
            tstep.micro_batch(batch, 0),
            tstep.make_train_rng(0, "cpu", 0, pp.stage))
    finally:
        pipeline._stage_inputs = stage_inputs
        txl.dropout = plain
    out = {"r": rs[0], "masks": masks, "stage": pp.stage}

    over = dict(n_layer=2, drop=0.2, embd_pdrop=0.0, dropattn=0.0)
    model = pp_model(state_dict, None, pp, **over)
    micro = to_gato_batch(_first_micro(raw), "cpu")
    with torch.no_grad():
        h = model.embed_concat(micro, with_targets=False)[0] if pp.first \
            else None
    shape = micro["rl"].label.shape
    got = [pipeline.pipeline_trunk(
        model, h, shape=shape, deterministic=False,
        generator=tstep.make_train_rng(1000 + i, "cpu", 0, pp.stage))
        for i in range(samples)]
    if pp.last:
        out["pipe_samples"] = torch.stack(got)
    if rank == 0:
        one = tiny_model(state_dict, **over)
        with torch.no_grad():
            out["trunk_samples"] = torch.stack([one.trunk(
                h, None, deterministic=False,
                generator=torch.Generator().manual_seed(5000 + i))[0]
                for i in range(samples)])

    model = pp_model(state_dict, None, pp, n_layer=2, drop=0.1,
                     embd_pdrop=0.1, dropattn=0.1)
    opt = OptimizerConfig(lr=1e-2, lr_decay_style="constant")
    state = tstep.init_train_state(model, opt, 100)
    step = tstep.make_train_step(model)
    gen = tstep.make_train_rng(0, "cpu", 0, pp.stage)
    const = to_gato_batch(const_raw, "cpu")
    losses = []
    for _ in range(6):
        state, met = step(state, const, gen)
        losses.append(float(met["loss"]))
    out["losses"] = losses
    out["replicated"] = {n: p.detach().clone()
                         for n, p in model.named_parameters()
                         if pipe_replicated(n)}
    return out
