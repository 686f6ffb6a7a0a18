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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bdm_db1_tpu_torch.core.config import OptimizerConfig
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


def global_norm(tensors: List[Tensor]) -> Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax
    ``global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


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
    (the JAX state's ``count``) that the schedules read."""

    def __init__(self, model: torch.nn.Module, cfg: OptimizerConfig,
                 train_iters: int):
        mask = decay_mask(model)
        super().__init__(list(model.parameters()), {})
        self.cfg = cfg
        self.decay = list(mask.values())
        self.lr = lr_schedule(cfg, train_iters)
        self.wd = wd_schedule(cfg, train_iters)
        self.count = 0

    def _params(self) -> List[Tensor]:
        return self.param_groups[0]["params"]

    def _moments(self, p: Tensor, mu_dtype, nu_dtype) -> Tuple[Tensor, Tensor]:
        st = self.state[p]
        if not st:
            st["mu"] = torch.zeros_like(p, dtype=mu_dtype or p.dtype)
            st["nu"] = torch.zeros_like(p, dtype=nu_dtype or p.dtype)
        return st["mu"], st["nu"]


class ChainOptimizer(_Base):
    """``make_optimizer``'s chain: clip -> adam -> masked wd -> -lr."""

    def __init__(self, model: torch.nn.Module, cfg: OptimizerConfig,
                 train_iters: int):
        if cfg.optimizer not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        super().__init__(model, cfg, train_iters)

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
            g_norm = global_norm(grads)
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
            g_norm = global_norm([p.grad for p, _ in pairs])
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
    """The step count, the model (its parameters) and the optimizer (its
    moments and schedule count)."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def init_train_state(model: torch.nn.Module, cfg: OptimizerConfig,
                     train_iters: int) -> TrainState:
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model, cfg, train_iters))


def make_train_rng(seed: int, device) -> torch.Generator:
    """The training generator (the dropout masks) on the model's device,
    seeded."""
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
    return int(sub.tokens.shape[0])


def make_loss_fn(model: torch.nn.Module) -> Callable:
    def loss_fn(micro, generator):
        _, loss = model(micro, compute_loss=True, deterministic=False,
                        loss_only=True, generator=generator)
        return loss

    return loss_fn


def make_train_step(model: torch.nn.Module, with_grad_norm: bool = False,
                    loss_fn: Optional[Callable] = None) -> Callable:
    """``train_step(state, batch, generator) -> (state, metrics)`` with
    metrics {"loss", "step"} (+ "grad_norm", the global norm of the
    averaged gradients). ``batch`` holds [accum, micro, ...] fields."""
    if loss_fn is None:
        loss_fn = make_loss_fn(model)

    def train_step(state: TrainState, batch, generator):
        accum = accum_steps(batch)
        params = [p for p in state.model.parameters() if p.requires_grad]
        if accum == 1:
            loss = loss_fn(micro_batch(batch, 0), generator)
            grads = torch.autograd.grad(loss, params)
            loss = loss.detach()
        else:
            gsum, lsum = None, None
            for a in range(accum):
                l = loss_fn(micro_batch(batch, a), generator)
                gs = torch.autograd.grad(l, params)
                if gsum is None:
                    gsum = [g.float() for g in gs]
                    lsum = l.detach()
                else:
                    for s, g in zip(gsum, gs):
                        s.add_(g)
                    lsum = lsum + l.detach()
                del gs, l
            grads = [s.div_(accum) for s in gsum]
            loss = lsum / accum
        for p, g in zip(params, grads):
            p.grad = g.to(p.dtype)
        metrics = {"loss": loss, "step": state.step}
        if with_grad_norm:
            metrics["grad_norm"] = global_norm(list(grads))
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step
