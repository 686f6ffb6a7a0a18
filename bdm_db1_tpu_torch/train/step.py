"""The train step (counterpart of bdm_db1_tpu/train/step.py): the optimizer,
the training state and one step of gradient accumulation and update.

Optimizers, as ``torch.optim.Optimizer`` subclasses over the model's
parameters (``model.parameters()`` lists the shared ``r_w_bias``/
``r_r_bias`` once, as the JAX tree holds them once):

* :class:`ChainOptimizer`, ``make_optimizer``'s optax chain: clip by global
  norm (``t / g_norm * max_norm`` above the limit) -> Adam (moments stored
  in ``adam_mu_dtype``/``adam_nu_dtype``, math in f32, bias correction at
  the post-increment count) -> weight decay on the masked parameters ->
  scale by -lr. The schedules read the pre-increment count. "adam" drops
  the weight decay, "sgd" the moments.
* :class:`FusedAdamW`, ``fused_adamw``: the same update in one pass per
  parameter, the clip as a factor ``clip_s`` and the second moment in the
  parameter's dtype.

Weight decay reaches every parameter that the JAX package decays: a leaf
of rank >= 2 there. The JAX layers are stacked on a leading [n_layer] axis
(``nn.scan``), so a layer's parameter has its own rank plus one there:
LayerNorm scales and biases and the FF biases are decayed too
(:func:`decay_mask`).

``make_train_step`` returns ``train_step(state, batch, generator)``: per
micro-batch the loss ``model(batch, compute_loss=True,
deterministic=False, loss_only=True)`` and its gradient; with accum > 1 the
f32 gradients are summed over the micro-batches and divided by accum, the
loss is their mean; then one optimizer step. Dropout draws from the
``torch.Generator`` passed in.

Data parallelism (a process group up): each rank's batch is its shard of
the global batch. A micro-batch's loss is the rank's masked NLL sum over
the loss-mask count of the global micro-batch, so that the ranks' losses
sum to the JAX package's mean over the whole micro-batch (pjit's batch
sharding); the gradients are then summed over the ranks, once a step.

Tensor parallelism (``model.tp``): the data parallelism above runs over
the data group (the ranks that hold the same shard), and the ranks of a
model group see the same rows, so they count them once. A sharded
parameter's gradient is this rank's and is never summed over the model
group; a replicated one's is whole on every rank, except under the
sequence-sharded option, where those of the layers (their LayerNorms and
the FF output bias, which see a slice of the sequence) are partial and are
summed over the model group first. The global norm (the clip,
``grad_norm``) sums the squares of the sharded leaves over the model
group and counts each replicated leaf once.

Pipeline parallelism (``model.pp``): the micro-batch runs through the
stages by parallel/pipeline.py's GPipe schedule (``make_pipelined_loss_fn``,
``model.pp.n_micro`` pipeline micro-batches); after the accumulation the
replicated parameters' gradients and the loss are summed over the pipe
group, then the data parallelism above runs over the data group (the
ranks at the same (stage, model rank)). A replicated parameter that only
some stages use (the embedding on stage 0, an untied head on the last)
counts as reached once that sum has run. The global norm counts each
stage's layers once (summed over the pipe group) and each replicated
leaf once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bdm_db1_tpu_torch.core.config import OptimizerConfig
from bdm_db1_tpu_torch.parallel.distributed import (
    all_reduce_f32, all_reduce_flat, summed, world_group,
)
from bdm_db1_tpu_torch.parallel.mesh import (
    data_axis, pipe_replicated, replicated,
)
from bdm_db1_tpu_torch.parallel.pipeline import (
    make_pipelined_loss_fn, reduce_over_stages,
)
from bdm_db1_tpu_torch.train.schedule import lr_schedule, wd_schedule

Tensor = torch.Tensor


def jax_rank(name: str, p: Tensor) -> int:
    """The rank of the parameter's leaf in the JAX tree: the layers'
    parameters (``h.{i}.*``) are stacked on a leading [n_layer] axis."""
    return p.dim() + (1 if name.startswith("h.") else 0)


def decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """{parameter name: decayed}, the JAX ``_decay_mask`` (rank >= 2 in the
    JAX tree), over ``model.named_parameters()``."""
    return {name: jax_rank(name, p) >= 2
            for name, p in model.named_parameters()}


def global_norm(tensors: List[Tensor], sharded: Optional[List[bool]] = None,
                tp=None, staged: Optional[List[bool]] = None,
                pp=None) -> Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax
    ``global_norm``). Under tensor parallelism (``tp``, with ``sharded``
    flagging each tensor that is this rank's shard) the sharded squares
    are summed over the model group and the replicated ones counted
    once; in a pipeline (``pp``, with ``staged`` flagging each tensor of
    this stage's layers) the staged squares are summed over the pipe
    group and the replicated ones counted once."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if tp is None and pp is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms).square()
    flag = torch.tensor(sharded if tp is not None else [False] * len(sq),
                        dtype=torch.bool, device=sq.device)
    if pp is None:
        shards = all_reduce_f32(torch.where(flag, sq, 0.0).sum(), tp.group)
        return torch.sqrt(shards + torch.where(flag, 0.0, sq).sum())
    stage = torch.tensor(staged, dtype=torch.bool, device=sq.device)
    # [sharded and staged, sharded and replicated over the stages]
    shards = torch.stack([torch.where(flag & stage, sq, 0.0).sum(),
                          torch.where(flag & ~stage, sq, 0.0).sum()])
    if tp is not None:
        shards = all_reduce_f32(shards, tp.group)
    layers = all_reduce_f32(
        shards[0] + torch.where(~flag & stage, sq, 0.0).sum(), pp.group)
    return torch.sqrt(layers + shards[1]
                      + torch.where(~flag & ~stage, sq, 0.0).sum())


def sharded_flags(model: torch.nn.Module) -> List[bool]:
    """Per ``named_parameters()`` entry: whether it is a tensor-parallel
    shard (all False without ``model.tp``)."""
    tp = getattr(model, "tp", None)
    return [tp is not None and not replicated(n)
            for n, _ in model.named_parameters()]


def staged_flags(model: torch.nn.Module) -> List[bool]:
    """Per ``named_parameters()`` entry: whether it is one of this
    pipeline stage's layers' (all False without ``model.pp``)."""
    pp = getattr(model, "pp", None)
    return [pp is not None and not pipe_replicated(n)
            for n, _ in model.named_parameters()]


def sequence_partial(name: str) -> bool:
    """Under the sequence-sharded option: whether the replicated
    parameter ``name`` sees a slice of the sequence (a layer's), so that
    its gradient is a partial sum over the model group."""
    return name.startswith("h.") and replicated(name)


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A moment's storage dtype by name; None stores it in the parameter's."""
    return getattr(torch, name) if name else None


def _bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """1 - b^count in f32 at the post-increment count."""
    c = np.float32(count)
    return (float(np.float32(1.0) - np.float32(b1) ** c),
            float(np.float32(1.0) - np.float32(b2) ** c))


def _adam_moments(g: Tensor, mu: Tensor, nu: Tensor, b1: float, b2: float,
                  eps: float, b1c: float, b2c: float) -> Tensor:
    """New moments in f32 (stored back in their own dtypes) and the Adam
    direction (mu / b1c) / (sqrt(nu / b2c) + eps) in f32."""
    mf = (mu.mul_(b1) if mu.dtype == torch.float32 else mu.float().mul_(b1))
    mf.add_(g, alpha=1.0 - b1)
    vf = (nu.mul_(b2) if nu.dtype == torch.float32 else nu.float().mul_(b2))
    vf.addcmul_(g, g, value=1.0 - b2)
    if mf is not mu:
        mu.copy_(mf)
    if vf is not nu:
        nu.copy_(vf)
    return (mf / b1c).div_((vf / b2c).sqrt_().add_(eps))


class _Base(torch.optim.Optimizer):
    """Parameters with their decay flags in one group; a host step count
    (the JAX state's ``count``) that the schedules read.

    ``state_dict()`` is the whole optimizer state by parameter name:
    ``{"count": int64 tensor, "mu": {name: tensor}, "nu": {name: tensor}}``
    with the moments in their stored dtypes (no moments for "sgd").
    ``load_state_dict`` copies such a dict into this optimizer's own
    tensors, creating the moments first (zeros, as the first step would),
    so a fresh optimizer can be loaded in place."""

    def __init__(self, model: torch.nn.Module, cfg: OptimizerConfig,
                 train_iters: int):
        mask = decay_mask(model)
        super().__init__(list(model.parameters()), {})
        self.cfg = cfg
        self.names = list(mask)
        self.decay = list(mask.values())
        self.tp = getattr(model, "tp", None)
        self.sharded = sharded_flags(model)
        self.pp = getattr(model, "pp", None)
        self.staged = staged_flags(model)
        self.lr = lr_schedule(cfg, train_iters)
        self.wd = wd_schedule(cfg, train_iters)
        self.count = 0

    def _params(self) -> List[Tensor]:
        return self.param_groups[0]["params"]

    def _grad_norm(self, grads: List[Tensor]) -> Tensor:
        """The global norm of ``grads``, those of the parameters that have
        a gradient, in order, over the model group and the stages."""
        have = [p.grad is not None for p in self._params()]
        return global_norm(
            grads, [s for s, h in zip(self.sharded, have) if h], self.tp,
            [s for s, h in zip(self.staged, have) if h], self.pp)

    def moment_dtypes(self):
        """(mu, nu) storage dtypes (None: the parameter's), or None when
        the optimizer keeps no moments."""
        return _dtype(self.cfg.adam_mu_dtype), _dtype(self.cfg.adam_nu_dtype)

    def _moments(self, p: Tensor, mu_dtype, nu_dtype) -> Tuple[Tensor, Tensor]:
        st = self.state[p]
        if not st:
            st["mu"] = torch.zeros_like(p, dtype=mu_dtype or p.dtype)
            st["nu"] = torch.zeros_like(p, dtype=nu_dtype or p.dtype)
        return st["mu"], st["nu"]

    def init_moments(self) -> None:
        """Create every parameter's moments now (zeros, in their configured
        dtypes) instead of at its first step; those that exist stay."""
        dts = self.moment_dtypes()
        if dts is not None:
            for p in self._params():
                self._moments(p, *dts)

    def state_dict(self) -> Dict[str, object]:
        self.init_moments()
        out: Dict[str, object] = {
            "count": torch.tensor(self.count, dtype=torch.int64)}
        if self.moment_dtypes() is not None:
            for key in ("mu", "nu"):
                out[key] = {n: self.state[p][key]
                            for n, p in zip(self.names, self._params())}
        return out

    @torch.no_grad()
    def load_state_dict(self, state_dict: Dict[str, object]) -> None:
        own = self.state_dict()
        if set(state_dict) != set(own):
            raise ValueError(f"optimizer state keys {sorted(state_dict)}, "
                             f"expected {sorted(own)}")
        for key in ("mu", "nu"):
            if key in own:
                if set(state_dict[key]) != set(own[key]):
                    raise ValueError(f"{key}: the parameter names differ")
                for n, t in own[key].items():
                    if state_dict[key][n] is not t:
                        t.copy_(state_dict[key][n])
        self.count = int(state_dict["count"])


class ChainOptimizer(_Base):
    """``make_optimizer``'s chain: clip -> adam -> masked wd -> -lr."""

    def __init__(self, model: torch.nn.Module, cfg: OptimizerConfig,
                 train_iters: int):
        if cfg.optimizer not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        super().__init__(model, cfg, train_iters)

    def moment_dtypes(self):
        return None if self.cfg.optimizer == "sgd" else super().moment_dtypes()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("the step takes no closure")
        cfg = self.cfg
        params = [p for p in self._params() if p.grad is not None]
        decay = [d for p, d in zip(self._params(), self.decay)
                 if p.grad is not None]
        grads = [p.grad.float() for p in params]
        if cfg.clip_grad and cfg.clip_grad > 0:
            g_norm = self._grad_norm(grads)
            trigger = g_norm < cfg.clip_grad
            grads = [torch.where(trigger, g, g / g_norm * cfg.clip_grad)
                     for g in grads]
        lr_t = self.lr(self.count)
        wd_t = self.wd(self.count)
        adam = cfg.optimizer in ("adamw", "adam")
        if adam:
            b1c, b2c = _bias_corrections(cfg.adam_beta1, cfg.adam_beta2,
                                         self.count + 1)
            mu_dt = _dtype(cfg.adam_mu_dtype)
            nu_dt = _dtype(cfg.adam_nu_dtype)
        decayed = cfg.optimizer == "adamw" and bool(cfg.weight_decay)
        for p, g, dec in zip(params, grads, decay):
            u = g
            if adam:
                mu, nu = self._moments(p, mu_dt, nu_dt)
                u = _adam_moments(g, mu, nu, cfg.adam_beta1, cfg.adam_beta2,
                                  cfg.adam_eps, b1c, b2c)
            if decayed and dec:
                u = u + wd_t * p.float()
            p.add_((-lr_t * u).to(p.dtype))
        self.count += 1


class FusedAdamW(_Base):
    """``fused_adamw``: clip factor, moments, bias correction, decoupled
    weight decay and the schedule in one pass per parameter. The second
    moment is stored in the parameter's dtype, as there."""

    def moment_dtypes(self):
        return _dtype(self.cfg.adam_mu_dtype), None

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("the step takes no closure")
        cfg = self.cfg
        pairs = [(p, d) for p, d in zip(self._params(), self.decay)
                 if p.grad is not None]
        lr_t = self.lr(self.count)
        wd_t = self.wd(self.count)
        b1c, b2c = _bias_corrections(cfg.adam_beta1, cfg.adam_beta2,
                                     self.count + 1)
        clip_s = None
        if cfg.clip_grad and cfg.clip_grad > 0:
            g_norm = self._grad_norm([p.grad for p, _ in pairs])
            clip_s = torch.where(g_norm < cfg.clip_grad,
                                 torch.ones_like(g_norm),
                                 cfg.clip_grad / g_norm)
        mu_dt = _dtype(cfg.adam_mu_dtype)
        for p, dec in pairs:
            g = p.grad.float()
            if clip_s is not None:
                g = g * clip_s
            mu, nu = self._moments(p, mu_dt, None)
            u = _adam_moments(g, mu, nu, cfg.adam_beta1, cfg.adam_beta2,
                              cfg.adam_eps, b1c, b2c)
            if cfg.weight_decay and dec:
                u.add_(p.float(), alpha=wd_t)
            p.add_((-lr_t * u).to(p.dtype))
        self.count += 1


def make_optimizer(model: torch.nn.Module, cfg: OptimizerConfig,
                   train_iters: int) -> _Base:
    """The fused AdamW when ``cfg.fused`` and "adamw", else the chain."""
    if cfg.fused and cfg.optimizer == "adamw":
        return FusedAdamW(model, cfg, train_iters)
    return ChainOptimizer(model, cfg, train_iters)


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters), the optimizer (its
    moments and schedule count) and the dropout generator the steps draw
    from (the ``Trainer`` sets it; a checkpoint carries its state, because
    it advances with every step where the JAX package folds the step into
    a fixed key)."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: Optional[torch.Generator] = None


def init_train_state(model: torch.nn.Module, cfg: OptimizerConfig,
                     train_iters: int) -> TrainState:
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model, cfg, train_iters))


def make_train_rng(seed: int, device, rank: int = 0,
                   stage: int = 0) -> torch.Generator:
    """The training generator (the dropout masks) on the model's device,
    seeded by ``seed`` on data rank 0 and by (``seed``, ``rank``) on the
    other data ranks of a data-parallel run, so that each draws its own
    masks (the JAX package draws one mask over the global batch). ``rank``
    is the data rank: the ranks of one tensor-parallel model group share
    it, and so draw the same masks on their replicated activations. A
    pipeline stage after the first is seeded by (``seed``, ``rank``,
    ``stage``): each stage draws its layers' masks from its own
    stream."""
    key = (seed, rank, stage) if stage else (seed, rank) if rank else None
    if key is not None:
        seed = int(np.random.SeedSequence(key).generate_state(1)[0])
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def micro_batch(batch: Dict[str, object], a: int) -> Dict[str, object]:
    """Slice [a] of every tensor field of a batch with [accum, micro, ...]
    fields."""
    return {m: dataclasses.replace(sub, **{
        f.name: getattr(sub, f.name)[a] for f in dataclasses.fields(sub)
        if getattr(sub, f.name) is not None})
        for m, sub in batch.items()}


def accum_steps(batch: Dict[str, object]) -> int:
    sub = next(iter(batch.values()))
    return int(sub.label.shape[0])


# parameters a batch may leave without a gradient: the vision tower, on a
# batch without images, and the RL timestep embedding, on a batch without
# RL rows (a text, captioning or VQA mixture)
UNREACHED_OK = ("vision_encoder.", "rl_local_timestep_embedding.")


def make_loss_fn(model: torch.nn.Module,
                 count_reduce: Optional[Callable] = None) -> Callable:
    """``loss_fn(micro, generator)``: the training loss of one micro-batch;
    ``count_reduce`` as in the model's forward."""
    def loss_fn(micro, generator):
        _, loss = model(micro, compute_loss=True, deterministic=False,
                        loss_only=True, generator=generator,
                        count_reduce=count_reduce)
        return loss

    return loss_fn


def _reduce_over_ranks(loss: Tensor, grads: list, names: List[str], group):
    """The loss summed over the ranks, and the gradients summed in place in
    flat buckets. The leaves without a gradient must be the same on every
    rank (the buckets' lists would differ, and the reduce hang): one small
    all_reduce of the loss and those flags first, and a ``RuntimeError``
    on every rank when they differ."""
    flags = torch.tensor([g is None for g in grads], dtype=torch.float32,
                         device=loss.device)
    small = summed(torch.cat([loss.reshape(1).float(), flags]), group)
    world = dist.get_world_size(group)
    split = [n for n, f in zip(names, small[1:].tolist())
             if f not in (0.0, world)]
    if split:
        raise RuntimeError(
            f"{len(split)} parameters have a gradient on some ranks and none "
            f"on others (their batches reach different groups): {split[:4]}")
    all_reduce_flat([g for g in grads if g is not None], group)
    return small[0]


def _check_reached(named, grads) -> None:
    """``RuntimeError`` naming the parameters that the loss reaches no
    gradient to, but those in ``UNREACHED_OK``."""
    lost = [n for (n, _), g in zip(named, grads)
            if g is None and not n.startswith(UNREACHED_OK)]
    if lost:
        raise RuntimeError(f"the loss reaches no gradient to "
                           f"{len(lost)} parameters: {lost[:4]}")


def make_train_step(model: torch.nn.Module, with_grad_norm: bool = False,
                    loss_fn: Optional[Callable] = None) -> Callable:
    """``train_step(state, batch, generator) -> (state, metrics)`` with
    metrics {"loss", "step"} (+ "grad_norm", the global norm of the
    averaged gradients). ``batch`` holds [accum, micro, ...] fields. The
    vision tower's parameters, which a batch without images does not
    reach, and the RL timestep embedding, which a batch without RL rows
    does not reach, keep ``grad`` None and the optimizer skips them (JAX's
    AdamW sees zero gradients there: it decays and moves them; the port
    leaves them as they are). Any other parameter the loss does not reach
    raises.

    Data parallelism over the world, whenever a process group is up (at
    world size 1 too), or over the data group of a tensor-parallel model
    (``model.tp``): ``batch`` is this rank's shard; each
    micro-batch's loss-mask count is summed over the ranks before the
    backward pass, the gradients are summed over them after the
    accumulation, and the reported loss, ``grad_norm`` and the optimizer's
    clip see the global values. A custom ``loss_fn`` must then return this
    rank's share of the global loss itself. Under the sequence-sharded
    option the layers' replicated gradients are summed over the model
    group first (:func:`sequence_partial`). A pipeline stage
    (``model.pp``) runs each micro-batch through the stages
    (parallel/pipeline.py) and takes no custom ``loss_fn``."""
    tp = getattr(model, "tp", None)
    pp = getattr(model, "pp", None)
    if pp is not None and loss_fn is not None:
        raise ValueError("a pipeline stage's step takes the pipelined loss "
                         "(parallel/pipeline.py), not a custom loss_fn")
    sharded = sharded_flags(model)
    staged = staged_flags(model)

    def train_step(state: TrainState, batch, generator):
        axis = data_axis(tp, pp)
        grp = world_group() if axis is None else axis.data_group
        count_reduce = (None if grp is None
                        else lambda count: summed(count, grp))
        accum = accum_steps(batch)
        named = [(n, p) for n, p in state.model.named_parameters()
                 if p.requires_grad]
        params = [p for _, p in named]
        if pp is not None:
            loss_and_grads = make_pipelined_loss_fn(model, count_reduce)
        else:
            lf = loss_fn or make_loss_fn(model, count_reduce)

            def loss_and_grads(micro, gen):
                l = lf(micro, gen)
                gs = torch.autograd.grad(l, params, allow_unused=True)
                _check_reached(named, gs)
                return l.detach(), gs

        if accum == 1:
            loss, grads = loss_and_grads(micro_batch(batch, 0), generator)
        else:
            gsum, lsum = None, None
            for a in range(accum):
                l, gs = loss_and_grads(micro_batch(batch, a), generator)
                if gsum is None:
                    gsum = [None if g is None else g.float() for g in gs]
                    lsum = l
                else:
                    for i, g in enumerate(gs):
                        if g is None:
                            continue
                        if gsum[i] is None:
                            gsum[i] = g.float()
                        else:
                            gsum[i].add_(g)
                    lsum = lsum + l
                del gs, l
            grads = [None if s is None else s.div_(accum) for s in gsum]
            loss = lsum / accum
        if pp is not None:
            grads = list(grads)
            loss = reduce_over_stages(loss, grads, [n for n, _ in named],
                                      params, pp)
            _check_reached(named, grads)
        if tp is not None and tp.sequence_sharded:
            all_reduce_flat([g for (n, _), g in zip(named, grads)
                             if g is not None and sequence_partial(n)],
                            tp.group)
        if grp is not None:
            loss = _reduce_over_ranks(loss, grads, [n for n, _ in named], grp)
        for p, g in zip(params, grads):
            p.grad = None if g is None else g.to(p.dtype)
        metrics = {"loss": loss, "step": state.step}
        if with_grad_norm:
            flags = [(s, t) for (n, p), s, t in zip(
                state.model.named_parameters(), sharded, staged)
                if p.requires_grad]
            pairs = [(g, f) for g, f in zip(grads, flags) if g is not None]
            metrics["grad_norm"] = global_norm(
                [g for g, _ in pairs], [f[0] for _, f in pairs], tp,
                [f[1] for _, f in pairs], pp)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step
