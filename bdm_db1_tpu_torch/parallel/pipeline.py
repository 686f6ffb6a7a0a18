"""GPipe pipeline parallelism (counterpart of
bdm_db1_tpu/parallel/pipeline.py).

The JAX package runs GPipe as one SPMD program: the stacked layers shard
over a "pipe" mesh axis, each of ``n_micro + S - 1`` ticks applies every
stage's layers to the activation it holds and ``ppermute`` rotates the
results to the next stage, and one ``jax.grad`` differentiates the whole
schedule. The port runs one process a stage (parallel/mesh.py
``PipelineParallel``): stage s of S holds layers [s n_layer / S,
(s + 1) n_layer / S) in a ``TransformerXL`` built with ``pp``, and the
parameters JAX replicates over "pipe" (the embeddings, the head,
``r_w_bias``/``r_r_bias``, the vision tower).

One micro-batch of a train step (:func:`make_pipelined_loss_fn`):

1. Every stage builds the attention mask and the positional embedding r
   (JAX :86-90). Stage 0 embeds the whole micro-batch (``embed_concat``)
   and applies the embedding dropout to h and to r, one draw each on the
   whole batch, as the one-process trunk does; a dropped r is broadcast
   over the pipe group, so that every stage uses the same one (JAX
   :92-103).
2. Forward, pipeline micro-batch by micro-batch in order. The split is
   strided: row b goes to micro-batch b % n_micro (JAX :150-152). A stage
   receives its input from the stage before it (stage 0 takes its rows of
   h), applies its layers (``TransformerXL.run_layers``: each layer
   checkpointed under ``cfg.remat``; the stage's column- and row-parallel
   layers under ``tp``) and sends the output on.
3. The last stage computes each micro-batch's loss (``loss_from_hidden``):
   its masked sum over the whole micro-batch's loss-mask count (summed
   over the data group), so the micro-batches' losses add up to the
   one-process loss.
4. Backward, micro-batch by micro-batch in reverse order: a stage receives
   the gradient of its output from the stage after it (the last stage
   starts from its loss), differentiates its layers and sends the gradient
   of its input back. Stage 0 then differentiates the embedding once,
   through the input gradients put back together.

Every rank issues its sends and receives in this one fixed order
(receive, compute, send), never in autograd's order across processes, so
the chain of stages never waits in a cycle. After the step's micro-batches
the gradients of the replicated parameters are summed over the pipe group
(:func:`reduce_over_stages`, from train/step.py): the tied table's (stage
0's embedding and the last stage's head), ``r_w_bias``/``r_r_bias``'s
(every stage), as JAX's one ``jax.grad`` sums them.

Dropout: each stage draws from a generator of its own (train/step.py
``make_train_rng``, seeded by (seed, data rank, stage)), layer by layer
and micro-batch by micro-batch, so no two (stage, layer, micro-batch)
draws share a mask. The masks are not the one-process trunk's (nor JAX's,
which folds its keys per (stage, layer, tick)); their distribution is.

Point to point (:func:`send`, :func:`recv`): NCCL sends tensors on the
card as they are; gloo's send reads a tensor's memory from the host, so
under gloo a CUDA tensor goes through a host copy. ``P2P`` counts the
calls.

Training only, without segment memory. The eval decode and the in-training
rollouts keep the one-process path (JAX :25-27) on the model that
:func:`gather_stages` puts together; the validation loss runs through the
stages (:func:`pipelined_loss`).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from bdm_db1_tpu_torch.ops.attention import causal_mask, same_length_mask
from bdm_db1_tpu_torch.ops.fast_dropout import dropout
from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding
from bdm_db1_tpu_torch.parallel.distributed import (
    all_reduce_flat, broadcast_flat, summed,
)
from bdm_db1_tpu_torch.parallel.mesh import (
    layer_index, pipe_replicated, stage_layers,
)

Tensor = torch.Tensor
P2P = {"send": 0, "recv": 0}


def _through_host(t: Tensor) -> bool:
    return t.is_cuda and "nccl" not in str(dist.get_backend())


def send(t: Tensor, dst: int) -> None:
    """Send ``t`` to world rank ``dst`` (blocking)."""
    P2P["send"] += 1
    t = t.detach().contiguous()
    dist.send(t.cpu() if _through_host(t) else t, dst=dst)


def recv(shape, dtype, device, src: int) -> Tensor:
    """A tensor of ``shape`` and ``dtype`` on ``device``, received from
    world rank ``src`` (blocking)."""
    P2P["recv"] += 1
    out = torch.empty(shape, dtype=dtype, device=device)
    if _through_host(out):
        host = torch.empty(shape, dtype=dtype)
        dist.recv(host, src=src)
        return out.copy_(host)
    dist.recv(out, src=src)
    return out


def _stage_inputs(model, h: Optional[Tensor], seq: int,
                  drop: Optional[torch.Generator]
                  ) -> Tuple[Optional[Tensor], Tensor, Tensor, bool]:
    """(h, r, mask, use_kernel) of a stage, as the one-process trunk makes
    them without memory: with ``drop`` stage 0 applies the embedding
    dropout to h and then r, and the dropped r is broadcast over the pipe
    group."""
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel

    cfg, pp, dev = model.cfg, model.pp, model.device
    mask = (same_length_mask(seq, seq, cfg.mem_len, device=dev)
            if cfg.same_length else causal_mask(seq, seq, device=dev))
    r = relative_positional_embedding(seq, cfg.n_embed,
                                      cfg.effective_clamp_len, device=dev)
    if drop is not None and cfg.embd_pdrop > 0.0:
        if pp.first:
            h = dropout(h, cfg.embd_pdrop, drop, cfg.dropout_impl)
            r = dropout(r, cfg.embd_pdrop, drop, cfg.dropout_impl)
        r = r.contiguous()
        broadcast_flat([r], src=dist.get_global_rank(pp.group, 0),
                       group=pp.group)
    use_kernel = use_rel_kernel(
        cfg, seq, seq, dev,
        use_dropatt=drop is not None and cfg.dropattn > 0.0)
    return h, r, mask, use_kernel


def _forward(model, h: Optional[Tensor], shape: Tuple[int, int],
             r: Tensor, mask: Tensor, use_kernel: bool,
             drop: Optional[torch.Generator]) -> List[Tuple[Tensor, Tensor]]:
    """Step 2 on this stage: (input, output) of every pipeline
    micro-batch, in order; in grad mode each input is a leaf that requires
    its gradient."""
    pp, n_micro = model.pp, model.pp.n_micro
    rows, seq = shape
    if rows % n_micro:
        raise ValueError(
            f"the pipeline splits a micro-batch of {rows} rows into "
            f"n_micro = {n_micro} micro-batches, which does not divide it "
            "(mesh.pipeline_microbatches)")
    part = (rows // n_micro, seq, model.cfg.n_embed)
    out = []
    for m in range(n_micro):
        if pp.first:
            x = h.detach()[m::n_micro].clone(
                memory_format=torch.contiguous_format)
        else:
            x = recv(part, model.dtype, model.device, pp.prev_rank)
        if torch.is_grad_enabled():
            x.requires_grad_(True)
        y = model.run_layers(x, r, mask, use_kernel, drop)
        if not pp.last:
            send(y, pp.next_rank)
        out.append((x, y))
    return out


def _add(grads: List[Optional[Tensor]], gs: Sequence[Optional[Tensor]]):
    """Sum ``gs`` into ``grads`` in f32, in place (None: not reached)."""
    for i, g in enumerate(gs):
        if g is not None:
            grads[i] = g.float() if grads[i] is None else grads[i].add_(g)


def pipeline_trunk(model, h: Optional[Tensor], shape=None,
                   deterministic: bool = True,
                   generator: Optional[torch.Generator] = None
                   ) -> Optional[Tensor]:
    """The GPipe forward over the stages of ``model.pp`` (collective over
    the pipe group): stage 0 passes the embedded micro-batch h [B, L, D],
    the other stages None and ``shape`` (B, L). The embedding dropout
    unless ``deterministic``, then every pipeline micro-batch through the
    stages (``model.pp.n_micro`` of them). Returns the trunk's
    output [B, L, D] on the last stage, None on the others: without
    dropout, the one-process ``TransformerXL.trunk`` without memory to
    float tolerance (tests/test_torch_pipeline.py, which holds it to the
    JAX ``pipeline_trunk`` too). No gradient: the train step's backward
    is :func:`make_pipelined_loss_fn`'s."""
    pp = model.pp
    shape = tuple(h.shape[:2]) if shape is None else tuple(shape)
    drop = None if deterministic else generator
    if drop is None and not deterministic:
        raise ValueError("deterministic=False needs the training "
                         "torch.Generator")
    with torch.no_grad():
        h, r, mask, use_kernel = _stage_inputs(model, h, shape[1], drop)
        outs = _forward(model, h, shape, r, mask, use_kernel, drop)
    if not pp.last:
        return None
    return torch.stack([y for _, y in outs], 1).reshape(
        *shape, model.cfg.n_embed)


def _count(loss_mask: Tensor, count_reduce: Optional[Callable]) -> Tensor:
    count = loss_mask.sum()
    return count if count_reduce is None else count_reduce(count)


def make_pipelined_loss_fn(model, count_reduce: Optional[Callable] = None
                           ) -> Callable:
    """``loss_and_grads(micro, generator) -> (loss, grads)``: this stage's
    share of one micro-batch's GPipe forward and backward (steps 1-4
    above; ``model.pp.n_micro`` pipeline micro-batches). ``grads`` holds
    one f32 gradient for each parameter of ``model.named_parameters()``
    that requires one, None where this stage's share does not reach it;
    ``loss`` is the micro-batch's loss on the last stage and 0 on the
    others, until :func:`reduce_over_stages`. ``count_reduce`` maps the
    micro-batch's loss-mask count to the count the masked sums are divided
    by (its sum over the data group). A micro-batch that ``n_micro`` does
    not divide raises ``ValueError``. The counterpart of the JAX
    ``make_pipelined_loss_fn``, whose ``jax.grad`` this schedule does by
    hand."""
    pp, n_micro = model.pp, model.pp.n_micro
    params = [p for _, p in model.named_parameters() if p.requires_grad]

    def loss_and_grads(micro, generator):
        loss_mask, label = model.concat_targets(micro)
        shape = tuple(label.shape)
        h = None
        if pp.first:
            h = model.embed_concat(micro, deterministic=False,
                                   with_targets=False, generator=generator)[0]
        h, r, mask, use_kernel = _stage_inputs(model, h, shape[1], generator)
        outs = _forward(model, h, shape, r, mask, use_kernel, generator)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        if pp.last:
            count = _count(loss_mask, count_reduce)
            losses = [model.loss_from_hidden(
                y, loss_mask[m::n_micro], label[m::n_micro], count)
                for m, (_, y) in enumerate(outs)]
            loss = torch.stack([x.detach().float() for x in losses]).sum()
        grads: List[Optional[Tensor]] = [None] * len(params)
        dxs = []
        for m in reversed(range(n_micro)):
            x, y = outs[m]
            if pp.last:
                top, g = losses[m], None
            else:
                top, g = y, recv(y.shape, y.dtype, y.device, pp.next_rank)
            gs = torch.autograd.grad(top, [*params, x], g, allow_unused=True)
            outs[m] = None
            _add(grads, gs[:-1])
            if pp.first:
                dxs.append(gs[-1])
            else:
                send(gs[-1], pp.prev_rank)
        if pp.first:
            dh = torch.stack(dxs[::-1], 1).reshape(h.shape)
            _add(grads, torch.autograd.grad(h, params, dh, allow_unused=True))
        return loss, grads

    return loss_and_grads


def reduce_over_stages(loss: Tensor, grads: List[Optional[Tensor]],
                       names: Sequence[str], params: Sequence[Tensor],
                       pp) -> Tensor:
    """After a stage's share of a step: the replicated parameters'
    gradients summed over the pipe group in place (a stage that did not
    reach one adds zeros; one that no stage reached stays None), and the
    loss summed too (the last stage's, on every stage), returned. One
    small all_reduce of the loss and the reached flags first."""
    rep = [i for i, n in enumerate(names) if pipe_replicated(n)]
    flags = torch.tensor([grads[i] is not None for i in rep],
                         dtype=torch.float32, device=loss.device)
    small = summed(torch.cat([loss.reshape(1).float(), flags]), pp.group)
    reached = [i for i, f in zip(rep, small[1:].tolist()) if f > 0]
    for i in reached:
        if grads[i] is None:
            grads[i] = torch.zeros(params[i].shape, dtype=torch.float32,
                                   device=params[i].device)
    all_reduce_flat([grads[i] for i in reached], pp.group)
    return small[0]


def pipelined_loss(model, micro, count_reduce: Optional[Callable] = None
                   ) -> Tensor:
    """The deterministic loss of one micro-batch through the stages (the
    validation loss; collective over the pipe group): the last stage's
    masked sum over the count (``count_reduce`` as above), on every
    stage."""
    pp = model.pp
    loss_mask, label = model.concat_targets(micro)
    with torch.no_grad():
        h = (model.embed_concat(micro, with_targets=False)[0] if pp.first
             else None)
        out = pipeline_trunk(model, h, shape=label.shape)
        loss = torch.zeros(1, dtype=torch.float32, device=model.device)
        if pp.last:
            loss = model.loss_from_hidden(
                out, loss_mask, label,
                _count(loss_mask, count_reduce)).float().reshape(1)
        return summed(loss, pp.group)[0]


def gather_stages(model) -> Optional[torch.nn.Module]:
    """The whole model on stage 0 of the pipe group, None on the other
    stages (collective over the group): each later stage sends its
    layers' tensors to stage 0, in state-dict order, stage after stage;
    stage 0 puts them, its own layers and its replicated tensors into a
    ``TransformerXL`` without ``pp`` (with the stage's ``tp``, so a
    tensor-parallel stage 0 gets the whole stack of its shards), built
    without a random init since every tensor is overwritten. No stage
    after the first holds more than its own share. The eval hook's
    rollouts and caption and VQA metrics run on it, as the JAX package's
    run on the gathered parameters."""
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL

    pp, n_layer = model.pp, model.cfg.n_layer
    own = model.state_dict()
    if not pp.first:
        first = dist.get_global_rank(pp.group, 0)
        for n, t in own.items():
            if layer_index(n) is not None:
                send(t, first)
        return None
    whole = torch.nn.utils.skip_init(
        TransformerXL, model.cfg, model.vocab, vision=model.vision,
        device=model.device, generator=torch.Generator(), tp=model.tp)
    whole.share_r_bias()
    sd = whole.state_dict()
    with torch.no_grad():
        for n, t in own.items():
            sd[n].copy_(t)
        for s in range(1, pp.size):
            src = dist.get_global_rank(pp.group, s)
            ids = stage_layers(n_layer, s, pp.size)
            for n in [n for n in sd if layer_index(n) in ids]:
                sd[n].copy_(recv(sd[n].shape, sd[n].dtype, sd[n].device,
                                 src))
    return whole
