"""TransformerXL decoder: the port of bdm_db1_tpu/models/transformer_xl.py
(ring-cache decode, the RL, text, captioning and VQA embeddings with the
vision tower, the full-sequence trunk with hidden-state memory, the loss
and ``decode_rl``).

Parameter names are the reference torch model's (``word_embedding.weight``,
``h.{i}.dec_attn.qkv_net.weight``, ``h.{i}.pos_ff.CoreNet.0.weight``, ...),
so a state dict made from the JAX params (train/convert.py) loads with
``strict=True``. Two differences from the reference layout: the word
embedding (and an untied head) spans the padded vocab, as in the JAX
package, and the shared ``r_w_bias``/``r_r_bias`` pair is one parameter
registered under every layer, as the reference's state dict lists it.

Decode runs over a ring-buffer K/V cache ``{"k", "v": [L, B, M, H, Dh],
"cursor": int}``: slot j holds the key of age rank (j - cursor) mod M, so
the positional BD scores and the attention mask are the aligned ones
rotated by ``cursor``. The cursor is a host int, so rotations and writes
need no device sync; new K/V rows are written in place at the cursor, layer
by layer after that layer's attention has read the cache. With
``decode_cache_dtype="int8"`` the cache is int8 with per-(slot, head) f32
scales ``"k_scale"``/``"v_scale"`` [L, B, M, H] beside it.

``decode_weight_dtype`` "int8"/"int8a8" serve the trunk matrices (qkv_net,
o_net, CoreNet.0, CoreNet.2) as int8 with per-output-channel scales once
:meth:`TransformerXL.quantize_decode_weights` has run on the loaded
weights: "int8" through the K9 kernel (ops/quant_matmul.py), "int8a8"
through the W8A8 int8 product.

The full-sequence trunk (:meth:`TransformerXL.trunk`, under ``forward``,
``decode_rl`` and the validation loss) runs every layer over
``[memory || x]`` with the relative attention picked by
:func:`use_rel_kernel`, the JAX package's ``_use_pallas`` gate: the kernel
route (K3 forward, K4/K5 backward, ops/flash_rel_attention.py; their plain
versions on the CPU) or ``rel_attention``. Hidden-state memory is
``[n_layer, B, mem_len, D]``. ``forward`` follows the caller's grad mode,
so the train step differentiates it; with ``deterministic=False`` dropout
runs at the JAX package's four sites (``embd_pdrop`` on the embedded input
and on the positional embedding, ``drop`` on the o_net and FF outputs,
``dropattn`` on the attention probabilities, which sends the attention to
``rel_attention`` as the JAX gate does), drawing from the
``torch.Generator`` the caller passes.

Images: ``vision_encoder`` (models/vision.py) is always built, as in the
reference torch model; a batch without images leaves its gradients None.
An RL row's j-th -1 token slot takes the j-th patch embedding of its
frames (``embed_rl``); captioning and VQA rows are ``[prompt | patches |
text]`` (``embed_ic``/``embed_vqa``). In training the patch positions are
drawn from the training generator.

Geometry buckets: ``decode_rl_kv_ring(real_q=...)`` takes a prime padded
with query-only rows and commits the real rows only. Captioning, VQA and
text generation fold their prefix in over the aligned cache
(``prime_ic_kv``, or ``decode_text_kv`` on a long prompt: the trunk's
route, K3 on the card) and then take one ring step a token
(``decode_text_kv``: K1 on the card).

Speculative decode: ``decode_rl_kv_ring(spec_tail=S)`` runs S trailing
guess rows that attend but are not committed.

Pre-LN models (``pre_lnorm``) normalise each sublayer's input (the
attention's over ``[memory || x]``) and add the sublayer's output to its
input with no LayerNorm after the sum. A zero K/V cache is a zero hidden
memory only after post-LN (LN(0) is the LayerNorm bias), so the ring and
aligned caches refuse pre-LN models, as the JAX package's asserts do; they
decode over hidden-state memory (``init_mems``/``decode_rl``).

Tensor parallelism (``tp``, parallel/mesh.py ``TensorParallel``): Megatron's
split over the model group. A rank's modules hold its shard of each weight
(parallel/mesh.py ``PARAM_AXES``): the q, k and v columns and the
positional projection of its heads ``[t H/tp, (t+1) H/tp)`` and their
biases, the o_net input rows of those heads, its share of the FF width (of
each GEGLU half), and its rows of the padded vocab in the word embedding
and an untied head. A column-parallel product takes the whole input and
sums its input gradient over the model group, a row-parallel one sums
its partial products: both sums in f32 and rounded once, as the
unsharded product rounds, before the bias, dropout, residual and
LayerNorm (:class:`_ColumnParallelLinear`, :class:`_RowParallelLinear`);
the embedding is a
vocab-parallel lookup (masked, then reduced); the tied head gives
vocab-sharded logits, which :meth:`TransformerXL.logits` gathers and the
loss reduces in the vocab-parallel fused CE. The ring and aligned caches
hold the rank's heads, so the kernels run on them. With
``tp.sequence_sharded`` the trunk without memory keeps the activations
between the blocks sharded along the sequence (Megatron-SP): all-gathered
before the QKV and FF-input products, reduce-scattered after o_net and the
FF output product. Every dropout mask of a tensor-parallel rank is the
one-process mask (the replicated activations draw it whole from the
generator that the ranks of a model group share; a slice of heads or of
the sequence draws the whole mask and keeps its part), so nothing is drawn
per model rank and the replicas never part.

Pipeline parallelism (``pp``, parallel/mesh.py ``PipelineParallel``): a
stage's model holds its layers, under their global names (``h.12.*`` on
stage 1 of 2 at 24 layers, :class:`StageLayers`), and the parameters the
JAX package replicates over "pipe" (the embeddings, the head, the shared
``r_w_bias``/``r_r_bias``, the vision tower). Its random init is the
one-process init's share. parallel/pipeline.py runs the stages; the
whole-stack forwards (the trunk, the ring and aligned decodes) refuse a
stage.

Rematerialization (``remat``, in grad mode): each layer runs under
``torch.utils.checkpoint`` and is recomputed in the backward pass, keeping
what ``remat_policy`` names: nothing ("full"), the products without a batch
dimension ("dots": qkv_net, r_net, o_net and the FF matrices) or only those
at most ``n_embed`` wide ("dots_narrow"); both "dots" policies keep the K3
forward's (out, m, l) too, as the JAX policies keep the Pallas kernel's
named outputs. The recompute replays the training generator's state, so
the dropout masks, the loss, the gradients and the generator after a step
are those without remat.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from bdm_db1_tpu_torch.core.config import (
    ModelConfig, VisionConfig, VocabConfig,
)
from bdm_db1_tpu_torch.data.input_specs import MODALITY_ORDER, GatoBatch
from bdm_db1_tpu_torch.models.activations import ACT2FN
from bdm_db1_tpu_torch.models.vision import VisionEmbedding
from bdm_db1_tpu_torch.ops.attention import (
    causal_mask, rel_attention, rel_shift, rel_shift_sliced, same_length_mask,
)
from bdm_db1_tpu_torch.ops.fast_dropout import dropout
from bdm_db1_tpu_torch.ops.flash_rel_attention import (
    KERNEL_HEAD_DIM as REL_KERNEL_HEAD_DIM, K3_OP, flash_rel_attention,
    kernel_route_applicable,
)
from bdm_db1_tpu_torch.ops.flash_ring_decode import (
    MAX_PRIME_Q, NEG_INF, combine_new_columns, combine_self_column,
    flash_ring_decode, flash_ring_prime_ap, kernels_take,
)
from bdm_db1_tpu_torch.ops.fused_ce import masked_cross_entropy_fused, mm_f32
from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding
from bdm_db1_tpu_torch.ops.quant_matmul import (
    quant_matmul, quantize_weight, w8a8_matmul,
)
from bdm_db1_tpu_torch.parallel.distributed import (
    all_reduce_f32, all_reduce_max, copy_to_tp, gather_from_tp,
    reduce_from_tp, reduce_scatter_tp, scatter_to_tp,
)
from bdm_db1_tpu_torch.parallel.mesh import (
    PipelineParallel, TensorParallel, check_pipeline_parallel,
    check_tensor_parallel, ring_cache_shardings, shard_rule, shard_tensor,
)

Tensor = torch.Tensor
INIT_STD = 0.02

# {"k": Tensor, "v": Tensor, "cursor": int}, + "k_scale"/"v_scale" when int8
RingCache = Dict[str, object]


def _linear(d_in: int, d_out: int, bias: bool, device, dtype) -> nn.Linear:
    return torch.nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias,
                                    device=device, dtype=dtype)


def _dense(x: Tensor, lin: nn.Linear, dtype, a8: bool = False) -> Tensor:
    """y = x @ W^T (+ b) in the compute dtype, as the JAX QDense promotes.
    A quantized layer (``weight_q`` int8 [N, K], ``weight_scale`` [N])
    goes through K9 (or, with ``a8``, the W8A8 product), whose f32 result
    is cast to the compute dtype before the bias is added."""
    b = None if lin.bias is None else lin.bias.to(dtype)
    w_q = getattr(lin, "weight_q", None)
    if w_q is None:
        return F.linear(x.to(dtype), lin.weight.to(dtype), b)
    shp = x.shape
    x2 = x.reshape(-1, shp[-1])
    y = (w8a8_matmul(x2, w_q, lin.weight_scale) if a8 else
         quant_matmul(x2.to(dtype).contiguous(), w_q, lin.weight_scale))
    y = y.reshape(*shp[:-1], w_q.shape[0]).to(dtype)
    return y if b is None else y + b


class _ColumnParallelLinear(torch.autograd.Function):
    """``x @ W^T (+ b)`` of a column-parallel shard W, its input taken from
    the model group: forward the compute-dtype product of the whole input
    (under the sequence-sharded option the sequence gathered first);
    backward dx = g @ W with f32 results, summed over the group in f32 (or
    reduce-scattered along the sequence) and rounded once, as the
    unsharded product's input gradient is; dW = g^T x and db in the
    compute dtype, as autograd forms them."""

    @staticmethod
    def forward(ctx, x, w, b, group, sp):
        if sp:
            x = gather_from_tp(x, group, 1)
        ctx.save_for_backward(x, w)
        ctx.group, ctx.sp, ctx.bias = group, sp, b is not None
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        dx = all_reduce_f32(mm_f32(g2, w).reshape(x.shape), ctx.group)
        if ctx.sp:
            r = torch.distributed.get_rank(ctx.group)
            n = torch.distributed.get_world_size(ctx.group)
            dx = dx.chunk(n, 1)[r]
        db = g2.sum(0) if ctx.bias else None
        return dx.to(x.dtype), g2.t() @ x2, db, None, None


class _RowParallelLinear(torch.autograd.Function):
    """``x @ W^T`` of a row-parallel shard W (x this rank's slice of the
    input features): forward the partial sums with f32 results, so that
    their sum over the model group rounds once, as the unsharded product
    does; backward the gradients of the compute-dtype product, dx = g @ W
    and dW = g^T x."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return mm_f32(x.reshape(-1, x.shape[-1]), w.t()).reshape(
            *x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        return ((g2 @ w).reshape(x.shape),
                g2.t() @ x.reshape(-1, x.shape[-1]))


def _col_linear(x: Tensor, lin: nn.Linear, dtype, a8: bool,
                tp: Optional[TensorParallel], sp: bool) -> Tensor:
    """A column-parallel product ``x @ W^T (+ b)`` in the compute dtype
    (:class:`_ColumnParallelLinear`); the int8 decode weights (no
    gradient) take the input as it is (the sequence gathered under the
    sequence-sharded option)."""
    if tp is None:
        return _dense(x, lin, dtype, a8)
    if getattr(lin, "weight_q", None) is not None:
        if sp:
            x = gather_from_tp(x, tp.group, 1)
        return _dense(x, lin, dtype, a8)
    b = None if lin.bias is None else lin.bias.to(dtype)
    return _ColumnParallelLinear.apply(x.to(dtype), lin.weight.to(dtype), b,
                                       tp.group, sp)


def _row_out(x: Tensor, lin: nn.Linear, dtype, a8: bool,
             tp: Optional[TensorParallel], sp: bool) -> Tensor:
    """A row-parallel product ``x @ W^T (+ b)``: this rank's partial sums in
    f32 (:class:`_RowParallelLinear`; K9 and W8A8 give f32), summed over
    the model group (reduce-scattered along the sequence under the
    sequence-sharded option), cast to the compute dtype, then the bias
    once. W8A8 quantizes each activation row by its max over the whole row
    (over the group), as the unsharded product does."""
    if tp is None:
        return _dense(x, lin, dtype, a8)
    w_q = getattr(lin, "weight_q", None)
    if w_q is None:
        y = _RowParallelLinear.apply(x.to(dtype), lin.weight.to(dtype))
    else:
        shp = x.shape
        x2 = x.reshape(-1, shp[-1])
        y = (w8a8_matmul(x2, w_q, lin.weight_scale,
                         lambda a: all_reduce_max(a, tp.group)) if a8 else
             quant_matmul(x2.to(dtype).contiguous(), w_q, lin.weight_scale))
        y = y.reshape(*shp[:-1], w_q.shape[0])
    y = (reduce_scatter_tp(y, tp.group, 1) if sp
         else reduce_from_tp(y, tp.group)).to(dtype)
    return y if lin.bias is None else y + lin.bias.to(dtype)


def _sp_shard(tp: Optional[TensorParallel], sp: bool, x: Tensor):
    """The dropout ``Shard`` of a sequence-sharded activation x [B, n, D]
    (this rank's n rows of n * tp), None otherwise."""
    if not sp:
        return None
    n = x.shape[1]
    return (1, tp.rank * n, n * tp.size)


def quantize_kv_rows(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric per-(..., head) int8 quantization over the trailing Dh
    axis: (int8 values, f32 scales with the Dh axis dropped). The zero
    guard is max(amax, 1e-8), not the weights' scale of 1.0."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_kv(q: Tensor, scale: Tensor, dtype) -> Tensor:
    """Inverse of :func:`quantize_kv_rows` (scales broadcast over Dh)."""
    return (q.float() * scale.float()[..., None]).to(dtype)


def _a8(cfg: ModelConfig) -> bool:
    """Quantized layers take the W8A8 product ("int8a8"), not K9."""
    return cfg.decode_weight_dtype == "int8a8"


def use_rel_kernel(cfg: ModelConfig, qlen: int, klen: int, device,
                   use_dropatt: bool = False) -> bool:
    """The JAX package's ``_use_pallas`` gate: "xla" and attention dropout
    take ``rel_attention``; otherwise shapes that the JAX kernel or its
    padding wrapper serve take the kernel route under "pallas" (the plain
    K3-K5 versions on the CPU; the CUDA kernels raise outside their
    contract), and under "auto" when the tensors are on CUDA and the model
    is inside the CUDA kernels' contract: bf16 with a head dim of
    ``REL_KERNEL_HEAD_DIM``."""
    if (cfg.attention_impl == "xla" or use_dropatt
            or not kernel_route_applicable(qlen, klen)):
        return False
    if cfg.attention_impl == "pallas":
        return True
    return (torch.device(device).type == "cuda"
            and cfg.d_head == REL_KERNEL_HEAD_DIM
            and cfg.dtype == "bfloat16")


def masked_cross_entropy(logits: Tensor, labels: Tensor, loss_mask: Tensor,
                         valid_vocab: int,
                         count: Optional[Tensor] = None) -> Tensor:
    """Masked mean CE in f32; the vocab tail from ``valid_vocab`` on is out
    of the softmax. The masked sum is divided by max(``count``, 1e-8),
    ``count`` defaulting to the mask's sum."""
    v = logits.shape[-1]
    if valid_vocab < v:
        pad_bias = torch.where(
            torch.arange(v, device=logits.device) < valid_vocab, 0.0, -1e30)
        logits = logits + pad_bias
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if count is None:
        count = loss_mask.sum()
    return (nll * loss_mask).sum() / torch.clamp(count, min=1e-8)


def _layer_norm(x: Tensor, ln: nn.LayerNorm) -> Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                        ln.bias.to(x.dtype), ln.eps)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_policy(name: str, n_embed: int):
    """The selective-checkpoint policy of ``remat_policy`` ``name`` (None
    for "full": keep nothing), the JAX package's ``remat_policy_for``:
    "dots" keeps every product without a batch dimension (``mm``/``addmm``,
    the JAX ``dots_with_no_batch_dims_saveable``), "dots_narrow" only those
    whose output is at most ``n_embed`` wide (``narrow_dots_policy``: qkv_net
    and the FF's first matrix are recomputed); both keep the K3 forward's
    outputs."""
    if name == "full":
        return None
    if name not in ("dots", "dots_narrow"):
        raise ValueError(f"remat_policy={name!r}; the port takes 'full', "
                         "'dots' and 'dots_narrow'")
    max_width = n_embed if name == "dots_narrow" else None

    def policy(ctx, op, *args, **kwargs):
        keep = op is K3_OP or (op in _DOTS and (
            max_width is None or args[-1].shape[-1] <= max_width))
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _remat_layer(layer: nn.Module, h: Tensor, mem: Optional[Tensor],
                 r: Tensor, mask: Tensor, use_kernel: bool,
                 drop: Optional[torch.Generator]) -> Tensor:
    """``layer(h, mem, r, mask, use_kernel, drop)`` under
    ``torch.utils.checkpoint``, keeping what the model's ``remat_policy``
    names. The checkpoint restores the global RNG states only, so the
    recompute sets the training generator ``drop`` back to its state at
    this forward (the same dropout masks) and afterwards to where the
    forward pass left it."""
    cfg = layer.dec_attn.cfg
    start = None if drop is None else drop.get_state()
    ran = []

    def run(h, mem, r):
        if start is None or not ran:
            ran.append(True)
            return layer(h, mem, r, mask, use_kernel, drop)
        after = drop.get_state()
        drop.set_state(start)
        try:
            return layer(h, mem, r, mask, use_kernel, drop)
        finally:
            drop.set_state(after)

    context = remat_policy(cfg.remat_policy, cfg.n_embed)
    kw = {} if context is None else {"context_fn": context}
    return checkpoint(run, h, mem, r, use_reentrant=False,
                      preserve_rng_state=False, **kw)


class PositionalEmbedding(nn.Module):
    """Holds the reference's sinusoidal ``inv_freq`` buffer; decode builds
    the embedding itself (ops/positional.py)."""

    def __init__(self, d_model: int, device):
        super().__init__()
        self.register_buffer("inv_freq", 1.0 / (10000.0 ** (
            torch.arange(0.0, d_model, 2.0, device=device) / d_model)))


class RelMultiHeadAttn(nn.Module):
    """Relative multi-head attention with fused QKV, post-LN residual. Under
    tensor parallelism ``tp`` it holds ``heads`` = n_head / tp of them."""

    def __init__(self, cfg: ModelConfig, device, dtype,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.heads = cfg.n_head // (1 if tp is None else tp.size)
        d, h, dh = cfg.n_embed, self.heads, cfg.d_head
        self.qkv_net = _linear(d, 3 * h * dh, False, device, dtype)
        self.r_net = _linear(d, h * dh, False, device, dtype)
        self.o_net = _linear(h * dh, d, False, device, dtype)
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_epsilon,
                                       device=device, dtype=dtype)
        if cfg.untie_r:
            self.r_w_bias = nn.Parameter(torch.empty(h, dh, device=device,
                                                     dtype=dtype))
            self.r_r_bias = nn.Parameter(torch.empty(h, dh, device=device,
                                                     dtype=dtype))

    def _residual(self, x: Tensor, attn: Tensor,
                  drop: Optional[torch.Generator] = None,
                  sp: bool = False) -> Tensor:
        """o_net (then dropout at ``cfg.drop`` when ``drop``, the training
        generator, is given), then the residual: ``x + out`` for pre-LN,
        else the post-LN one with the DeepNorm alpha. Under tensor
        parallelism o_net's partial sums are reduced first (``sp``: x is
        this rank's slice of the sequence, and attn the whole sequence's)."""
        cfg = self.cfg
        b, qlen = attn.shape[:2]
        out = _row_out(attn.to(x.dtype).reshape(b, qlen, -1), self.o_net,
                       x.dtype, _a8(cfg), self.tp, sp)
        if drop is not None:
            out = dropout(out, cfg.drop, drop, cfg.dropout_impl,
                          _sp_shard(self.tp, sp, out))
        if cfg.pre_lnorm:
            return x + out
        alpha = (2 * cfg.n_layer) ** 0.25 if cfg.use_deepnorm else 1.0
        return _layer_norm(x * alpha + out, self.layer_norm)

    def _pre(self, x: Tensor) -> Tensor:
        """The QKV projection's input: LayerNorm'd for pre-LN."""
        return _layer_norm(x, self.layer_norm) if self.cfg.pre_lnorm else x

    def forward(self, x: Tensor, r: Tensor, mem: Optional[Tensor],
                mask: Tensor, use_kernel: bool,
                drop: Optional[torch.Generator] = None,
                sp: bool = False) -> Tensor:
        """One layer over ``[mem || x]`` (hidden states; mem [B, M, D] or
        None): x [B, q, D], r [M+q, D] positional embeddings, mask [q, M+q]
        (True = banned). ``drop`` is the training generator (None:
        deterministic). ``sp``: x is this rank's slice of the sequence
        (the sequence-sharded option, no memory). Returns the layer's
        output [B, q, D]."""
        return self._residual(
            x, self.attend(x, r, mem, mask, use_kernel, drop, sp), drop, sp)

    def attend(self, x: Tensor, r: Tensor, mem: Optional[Tensor],
               mask: Tensor, use_kernel: bool,
               drop: Optional[torch.Generator] = None,
               sp: bool = False) -> Tensor:
        """The attention part of :meth:`forward`: [B, q, H, Dh] before o_net.
        QKV runs over ``[mem || x]`` (LayerNorm'd first for pre-LN); q is
        its last q rows; r_net projects r in the compute dtype;
        ``use_kernel`` picks K3-K5 (with f32 biases, as the JAX kernel route
        takes them) or ``rel_attention``, which applies the attention
        dropout (``cfg.dropattn``) when ``drop`` is given."""
        cfg = self.cfg
        h, dh = self.heads, cfg.d_head
        dtype = x.dtype
        cat = x if mem is None else torch.cat([mem.to(dtype), x], dim=1)
        qlen = x.shape[1] * (self.tp.size if sp else 1)
        q, k, v = _col_linear(self._pre(cat), self.qkv_net, dtype, _a8(cfg),
                              self.tp, sp).split(h * dh, dim=-1)
        klen = q.shape[1]
        q = q[:, -qlen:].unflatten(-1, (h, dh))
        k, v = k.unflatten(-1, (h, dh)), v.unflatten(-1, (h, dh))
        r_k = _dense(r.to(dtype), self.r_net, dtype).view(klen, h, dh)
        return self._attention(q, k, v, r_k, mask, use_kernel, drop)

    def _attention(self, q: Tensor, k: Tensor, v: Tensor, r_k: Tensor,
                   mask: Tensor, use_kernel: bool,
                   drop: Optional[torch.Generator] = None) -> Tensor:
        """q [B, q, H, Dh] over k/v [B, klen, H, Dh] (memory rows first),
        r_k [klen, H, Dh]: K3 when ``use_kernel`` (f32 biases, as the JAX
        kernel route takes them), else ``rel_attention`` with ``mask``."""
        cfg = self.cfg
        dtype = q.dtype
        if use_kernel:
            return flash_rel_attention(
                q, k, v, r_k, self.r_w_bias.float(), self.r_r_bias.float(),
                mem_len=cfg.mem_len, same_length=cfg.same_length,
                scale=1.0 / cfg.d_head ** 0.5).to(dtype)
        rate = cfg.dropattn if drop is not None else 0.0
        shard = None
        if self.tp is not None:     # this rank's heads of the whole draw
            shard = (1, self.tp.rank * self.heads, self.cfg.n_head)
        return rel_attention(q, k, v, r_k, self.r_w_bias, self.r_r_bias,
                             mask, compute_dtype=dtype, dropout_rate=rate,
                             generator=drop, dropout_shard=shard)

    def attend_kv(self, x: Tensor, rk: Tensor, k_cache: Tensor,
                  v_cache: Tensor, mask: Tensor, use_kernel: bool
                  ) -> Tuple[Tensor, Tensor, Tensor]:
        """Attention over an aligned K/V cache (k_cache/v_cache [B, M, H,
        Dh], oldest first) and the new tokens: the JAX package's cache mode.
        Only x [B, q, D] is projected; rk [M+q, H, Dh] is this layer's
        precomputed r_net projection; mask [q, M+q]. The route is the
        trunk's: K3 over [cache || new] when ``use_kernel``, else
        ``rel_attention``. Returns (attn [B, q, H, Dh] before o_net, k_x,
        v_x)."""
        cfg = self.cfg
        dtype = x.dtype
        b, qlen = x.shape[:2]
        q, k_x, v_x = _col_linear(self._pre(x), self.qkv_net, dtype,
                                  _a8(cfg), self.tp, False).view(
            b, qlen, 3, self.heads, cfg.d_head).unbind(2)
        k = torch.cat([k_cache.to(dtype), k_x], dim=1)
        v = torch.cat([v_cache.to(dtype), v_x], dim=1)
        return (self._attention(q, k, v, rk.to(dtype), mask, use_kernel),
                k_x, v_x)

    def forward_ring(self, x: Tensor, rk: Tensor, cache: RingCache,
                     layer: int, mask: Tensor, mask_s: Tensor,
                     use_kernels: bool) -> Tuple[Tensor, Tensor, Tensor]:
        """One layer over the ring cache. x [B, q, D]; rk [M+q, H, Dh]
        this layer's positional projections; cache the stacked ring cache
        (read at ``layer``, cursor ``cache["cursor"]``); mask [q, M+q]
        aligned, mask_s its cache columns rotated into ring order. Returns
        (out, k_x, v_x), the new tokens' K/V rows [B, q, H, Dh] in the
        compute dtype."""
        attn, k_x, v_x = self.attend_ring(x, rk, cache, layer, mask, mask_s,
                                          use_kernels)
        return self._residual(x, attn), k_x, v_x

    def attend_ring(self, x: Tensor, rk: Tensor, cache: RingCache,
                    layer: int, mask: Tensor, mask_s: Tensor,
                    use_kernels: bool) -> Tuple[Tensor, Tensor, Tensor]:
        """The attention part of :meth:`forward_ring`: (attn [B, q, H, Dh]
        before o_net, k_x, v_x). It reads the cache and writes nothing. The
        self column and the new tokens' q x q block use this forward's
        unquantized k_x/v_x."""
        cfg = self.cfg
        h, dh = self.heads, cfg.d_head
        dtype = x.dtype
        b, qlen = x.shape[:2]
        k_cache, v_cache = cache["k"], cache["v"]
        k_scale, v_scale = cache.get("k_scale"), cache.get("v_scale")
        cursor = int(cache["cursor"])
        M = k_cache.shape[2]
        r_w, r_r = self.r_w_bias, self.r_r_bias
        q, k_x, v_x = _col_linear(self._pre(x), self.qkv_net, dtype,
                                  _a8(cfg), self.tp, False).view(
            b, qlen, 3, h, dh).unbind(2)
        qf = q.float()
        qw = qf + r_w.float()                                  # [B, q, H, Dh]
        qr = qf + r_r.float()
        rkf = rk.float()
        scale = 1.0 / dh ** 0.5
        if use_kernels and qlen == 1:
            qw0 = qw[:, 0]
            bd = torch.einsum("bhd,jhd->bhj", qr[:, 0], rkf)   # [B, H, M+1]
            # aligned column c lives at ring slot (cursor + c) % M
            bd_s = torch.roll(bd[..., :M], cursor, dims=-1)
            bias = torch.where(mask_s[0], NEG_INF, bd_s * scale)
            o_un, m_s, l_s = flash_ring_decode(
                k_cache, v_cache, qw0.to(dtype), bias, layer, k_scale,
                v_scale, scale=scale)
            # distance-0 self column (never masked at q == 1)
            s_x = ((qw0 * k_x[:, 0].float()).sum(-1) + bd[..., M]) * scale
            attn = combine_self_column(o_un, m_s, l_s, s_x, v_x[:, 0])[:, None]
        elif use_kernels:
            bd = rel_shift_sliced(torch.einsum("bihd,jhd->bhij", qr, rkf))
            bd_s = torch.roll(bd[..., :M], cursor, dims=-1)
            bias = torch.where(mask_s, NEG_INF, bd_s * scale)
            o_un, m_s, l_s = flash_ring_prime_ap(
                k_cache, v_cache, qw.transpose(1, 2).to(dtype).contiguous(),
                bias, layer, k_scale, v_scale, scale=scale)
            # the new tokens' q x q block, causal among themselves
            ac_x = torch.einsum("bihd,bjhd->bhij", qw, k_x.float())
            s_new = torch.where(mask[:, M:], NEG_INF,
                                (ac_x + bd[..., M:]) * scale)
            attn = combine_new_columns(o_un, m_s, l_s, s_new, v_x,
                                       compute_dtype=dtype)
        else:
            ks = vs = None
            if k_scale is not None:
                ks, vs = k_scale[layer], v_scale[layer]
            attn = self._plain_ring(qw, qr, k_x, v_x, rkf, k_cache[layer],
                                    v_cache[layer], ks, vs, cursor, mask,
                                    mask_s, scale, dtype)
        return attn, k_x, v_x

    @staticmethod
    def _plain_ring(qw, qr, k_x, v_x, rkf, k_c, v_c, ks, vs, cursor, mask,
                    mask_s, scale, dtype) -> Tensor:
        """The plain ring branch: full f32 scores over [ring cache | new
        tokens], masked softmax, PV in the compute dtype. An int8 cache's
        scales ks/vs [B, M, H] land on its scores and on its f32
        probabilities before the cast. [B, q, H, Dh]."""
        M = k_c.shape[1]
        qlen = qw.shape[1]
        ac_s = torch.einsum("bihd,bjhd->bhij", qw, k_c.float())
        if ks is not None:
            ac_s = ac_s * ks.float().transpose(1, 2)[:, :, None, :]
        ac_x = torch.einsum("bihd,bjhd->bhij", qw, k_x.float())
        bd = torch.einsum("bihd,jhd->bhij", qr, rkf)           # [B,H,q,M+q]
        # small q: the sliced shift (differs only in always-masked columns)
        bd = rel_shift_sliced(bd) if qlen <= 64 else rel_shift(bd)
        bd_s = torch.roll(bd[..., :M], cursor, dims=-1)
        scores = torch.cat([ac_s + bd_s, ac_x + bd[..., M:]], dim=-1) * scale
        mask_ring = torch.cat([mask_s, mask[:, M:]], dim=-1)
        scores = torch.where(mask_ring, NEG_INF, scores)
        probs = torch.softmax(scores, dim=-1)
        if vs is not None:
            probs = torch.cat([probs[..., :M]
                               * vs.float().transpose(1, 2)[:, :, None, :],
                               probs[..., M:]], dim=-1)
        probs = probs.to(dtype)
        v_all = torch.cat([v_c.to(dtype), v_x], dim=1)
        return torch.einsum("bhij,bjhd->bihd", probs, v_all)


class Activation(nn.Module):
    """The activation slot of ``CoreNet`` (no parameters)."""

    def __init__(self, name: str):
        super().__init__()
        self.fn = ACT2FN[name]

    def forward(self, x: Tensor) -> Tensor:
        return self.fn(x)


class PositionwiseFF(nn.Module):
    """FFN ``CoreNet = [Linear, act, Linear]`` (GEGLU halves the width
    between them): post-LN with the DeepNorm alpha, or pre-LN (the input
    LayerNorm'd, ``h + x``). Under tensor parallelism ``tp`` a rank holds
    1 / tp of the width: of CoreNet.0 its columns of each GEGLU half, of
    CoreNet.2 the matching input rows."""

    def __init__(self, cfg: ModelConfig, device, dtype,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        n = 1 if tp is None else tp.size
        d_mid = cfg.d_inner // (2 if cfg.activation_fn == "geglu" else 1)
        self.CoreNet = nn.Sequential(
            _linear(cfg.n_embed, cfg.d_inner // n, True, device, dtype),
            Activation(cfg.activation_fn),
            _linear(d_mid // n, cfg.n_embed, True, device, dtype))
        self.layer_norm = nn.LayerNorm(cfg.n_embed,
                                       eps=cfg.layer_norm_epsilon,
                                       device=device, dtype=dtype)

    def forward(self, x: Tensor, drop: Optional[torch.Generator] = None,
                sp: bool = False) -> Tensor:
        wi, act, wo = self.CoreNet
        cfg = self.cfg
        a8 = _a8(cfg)
        inp = _layer_norm(x, self.layer_norm) if cfg.pre_lnorm else x
        h = _row_out(act(_col_linear(inp, wi, x.dtype, a8, self.tp, sp)), wo,
                     x.dtype, a8, self.tp, sp)
        if drop is not None:
            h = dropout(h, cfg.drop, drop, cfg.dropout_impl,
                        _sp_shard(self.tp, sp, h))
        if cfg.pre_lnorm:
            return h + x
        alpha = (2 * cfg.n_layer) ** 0.25 if cfg.use_deepnorm else 1.0
        return _layer_norm(x * alpha + h, self.layer_norm)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        self.tp = tp
        self.dec_attn = RelMultiHeadAttn(cfg, device, dtype, tp)
        self.pos_ff = PositionwiseFF(cfg, device, dtype, tp)

    def forward(self, h: Tensor, mem: Optional[Tensor], r: Tensor,
                mask: Tensor, use_kernel: bool,
                drop: Optional[torch.Generator] = None) -> Tensor:
        """Attention over ``[mem || h]``, then the FF; ``drop`` is the
        training generator (None: deterministic). Under the
        sequence-sharded option and without memory, h is this rank's slice
        of the sequence."""
        sp = self.tp is not None and self.tp.sequence_sharded and mem is None
        return self.pos_ff(
            self.dec_attn(h, r, mem, mask, use_kernel, drop, sp), drop, sp)

    def forward_ring(self, x, rk, cache, layer, mask, mask_s, use_kernels):
        h, k_x, v_x = self.dec_attn.forward_ring(
            x, rk, cache, layer, mask, mask_s, use_kernels)
        return self.pos_ff(h), k_x, v_x

    def forward_kv(self, x, rk, k_cache, v_cache, mask, use_kernel):
        a = self.dec_attn
        attn, k_x, v_x = a.attend_kv(x, rk, k_cache, v_cache, mask,
                                     use_kernel)
        return self.pos_ff(a._residual(x, attn)), k_x, v_x


class StageLayers(nn.ModuleList):
    """Layers ``start``, ``start + 1``, ... of the stack, registered under
    those global indices, so that a pipeline stage's state dict keeps the
    one-process names; indexing and iteration are local."""

    def __init__(self, layers, start: int = 0):
        super().__init__()
        self.start = start
        for i, layer in enumerate(layers):
            self.add_module(str(start + i), layer)

    def _get_abs_string_index(self, idx):
        return str(self.start + int(super()._get_abs_string_index(idx)))


class TransformerXL(nn.Module):
    """The decoder. ``device`` defaults to the card and CUDA is never
    swapped for the CPU: asking for it where there is none raises. Weights
    are drawn from ``generator`` (normal(0.02) matrices and embeddings,
    zero biases, unit LayerNorm scales; the vision tower's convolutions
    lecun-normal) directly in ``cfg.param_dtype`` on that device.
    ``vision`` defaults to ``VisionConfig()``. With ``tp`` (tensor
    parallelism) the model holds this rank's shards, and a ``tp.size``
    that does not divide the heads, the FF width or the padded vocab
    raises ``ValueError``; its random init is the slice of the one-process
    init from the same generator. With ``pp`` (a pipeline stage) it holds
    the stage's layers (``pp.layers``) and the replicated parameters, a
    stage count that does not divide ``n_layer`` raises ``ValueError``,
    and its random init is the one-process init's share."""

    def __init__(self, cfg: ModelConfig, vocab: VocabConfig, *,
                 vision: Optional[VisionConfig] = None,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 tp: Optional[TensorParallel] = None,
                 pp: Optional[PipelineParallel] = None):
        super().__init__()
        for name, val, ok in (
                ("decode_cache_dtype", cfg.decode_cache_dtype, ("", "int8")),
                ("decode_weight_dtype", cfg.decode_weight_dtype,
                 ("", "int8", "int8a8"))):
            if val not in ok:
                raise ValueError(f"{name}={val!r}; the port takes {ok}")
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was asked for but torch.cuda.is_available() "
                "is false; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.vocab = vocab
        self.vision = vision if vision is not None else VisionConfig()
        self.layout = vocab.layout()
        self.dtype = getattr(torch, cfg.dtype)
        pdt = getattr(torch, cfg.param_dtype)
        d = cfg.n_embed
        n = 1 if tp is None else tp.size
        check_tensor_parallel(cfg, self.layout.padded_vocab_size, n)
        if pp is not None:
            check_pipeline_parallel(cfg.n_layer, pp.size)
        self.tp = tp
        self.pp = pp
        # this rank's heads and vocab rows (all of them without tp)
        self.heads = cfg.n_head // n
        V = self.layout.padded_vocab_size // n
        self.word_embedding = torch.nn.utils.skip_init(
            nn.Embedding, V, d, device=dev, dtype=pdt)
        self.rl_local_timestep_embedding = torch.nn.utils.skip_init(
            nn.Embedding, cfg.rl_timestep_vocab_size, d, device=dev,
            dtype=pdt)
        self.pos_emb = PositionalEmbedding(d, dev)
        if not cfg.untie_r:
            self.r_w_bias = nn.Parameter(
                torch.empty(self.heads, cfg.d_head, device=dev, dtype=pdt))
            self.r_r_bias = nn.Parameter(
                torch.empty(self.heads, cfg.d_head, device=dev, dtype=pdt))
        if pp is None:
            self.h = nn.ModuleList(
                DecoderLayer(cfg, dev, pdt, tp) for _ in range(cfg.n_layer))
        else:
            ids = pp.layers(cfg.n_layer)
            self.h = StageLayers([DecoderLayer(cfg, dev, pdt, tp)
                                  for _ in ids], ids.start)
        self.share_r_bias()
        if not cfg.share_input_output_embedding:
            self.lm_head = _linear(d, V, False, dev, pdt)
        self.vision_encoder = VisionEmbedding(cfg, self.vision, dev, pdt)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.word_embedding.weight.device

    def share_r_bias(self) -> None:
        """Without ``cfg.untie_r``: one shared r_w_bias/r_r_bias pair,
        listed under every layer (again after ``to_empty``, which gives
        each module a parameter of its own)."""
        if not self.cfg.untie_r:
            for layer in self.h:
                layer.dec_attn.r_w_bias = self.r_w_bias
                layer.dec_attn.r_r_bias = self.r_r_bias

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        tp = self.tp

        def normal(p, name):
            """p drawn whole; a shard draws the whole tensor and keeps its
            slice (:func:`shard_rule` of ``name``)."""
            rule = None if tp is None else shard_rule(name, cfg)
            if rule is None:
                p.normal_(0.0, INIT_STD, generator=gen)
                return
            shape = list(p.shape)
            shape[rule[0]] *= tp.size
            whole = torch.empty(shape, device=p.device, dtype=p.dtype)
            p.copy_(shard_tensor(whole.normal_(0.0, INIT_STD, generator=gen),
                                 *rule, tp.rank, tp.size))

        normal(self.word_embedding.weight, "word_embedding.weight")
        normal(self.rl_local_timestep_embedding.weight,
               "rl_local_timestep_embedding.weight")
        if not cfg.untie_r:
            normal(self.r_w_bias, "r_w_bias")
            normal(self.r_r_bias, "r_r_bias")
        # a pipeline stage draws the other stages' layers too, into
        # scratch tensors, so that its own draws are the one-process ones
        start = getattr(self.h, "start", 0)
        for i in range(cfg.n_layer):
            held = start <= i < start + len(self.h)
            layer = self.h[i - start if held else 0]
            a, f = layer.dec_attn, layer.pos_ff
            drawn = [(lin.weight, name + ".weight") for lin, name in (
                (a.qkv_net, "qkv_net"), (a.r_net, "r_net"),
                (a.o_net, "o_net"), (f.CoreNet[0], "CoreNet.0"),
                (f.CoreNet[2], "CoreNet.2"))]
            if cfg.untie_r:
                drawn[:0] = [(a.r_w_bias, "r_w_bias"), (a.r_r_bias, "r_r_bias")]
            for p, name in drawn:
                normal(p if held else torch.empty_like(p), name)
            if not held:
                continue
            for lin in (f.CoreNet[0], f.CoreNet[2]):
                lin.bias.zero_()
            for ln in (a.layer_norm, f.layer_norm):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        if not cfg.share_input_output_embedding:
            normal(self.lm_head.weight, "lm_head.weight")
        self.vision_encoder.reset_parameters(gen)

    # ---- embedding and head -------------------------------------------------
    def _word(self, tokens: Tensor) -> Tensor:
        """The word embedding in the compute dtype; under tensor
        parallelism a vocab-parallel lookup: the ids outside this rank's
        rows embed to 0, and the ranks' rows are summed (one is nonzero)."""
        w = self.word_embedding.weight
        if self.tp is None:
            return F.embedding(tokens, w).to(self.dtype)
        local = tokens - self.tp.rank * w.shape[0]
        outside = (local < 0) | (local >= w.shape[0])
        emb = F.embedding(local.clamp(0, w.shape[0] - 1), w).masked_fill(
            outside[..., None], 0.0)
        return reduce_from_tp(emb, self.tp.group).to(self.dtype)

    def embed_rl(self, tokens: Tensor, position_id: Tensor,
                 images: Optional[Tensor] = None, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None) -> Tensor:
        """Word-embed ids >= 0, splice patch embeddings at the -1 slots
        (the j-th slot of a row takes the j-th patch of the row's frames
        ``images`` [B, T, H, W, C]; without images a slot embeds to 0),
        add the local-timestep embedding."""
        img_slot = tokens < 0
        emb = self._word(tokens.clamp(min=0))
        emb = emb.masked_fill(img_slot[..., None], 0.0)
        if images is not None:
            b = tokens.shape[0]
            vis = self.vision_encoder(
                images.reshape((-1,) + tuple(images.shape[2:])),
                deterministic, generator).reshape(b, -1, self.cfg.n_embed)
            slot = (torch.cumsum(img_slot.to(torch.int64), dim=1) - 1).clamp(
                0, vis.shape[1] - 1)
            gathered = torch.gather(
                vis, 1, slot[..., None].expand(-1, -1, vis.shape[-1]))
            emb = torch.where(img_slot[..., None], gathered, emb)
        return emb + F.embedding(
            position_id, self.rl_local_timestep_embedding.weight
        ).to(self.dtype)

    def embed_nlp(self, tokens: Tensor) -> Tensor:
        """Text: the word embedding alone (no timestep term)."""
        return self._word(tokens)

    def embed_ic(self, prompt: Tensor, images: Tensor, text: Tensor,
                 deterministic: bool = True,
                 generator: Optional[torch.Generator] = None) -> Tensor:
        """Captioning and VQA rows: [prompt | patches of images [B, H, W,
        C] | text], word embeddings without the timestep term."""
        vis = self.vision_encoder(images, deterministic, generator)
        return torch.cat([self._word(prompt), vis, self._word(text)], dim=1)

    embed_vqa = embed_ic

    def logits(self, h: Tensor) -> Tensor:
        """f32 logits over the padded vocab; under tensor parallelism each
        rank's vocab rows, gathered (every rank holds all of them)."""
        w = (self.word_embedding.weight if self.cfg.share_input_output_embedding
             else self.lm_head.weight)
        if self.tp is None:
            return F.linear(h.to(self.dtype), w.to(self.dtype)).float()
        h = copy_to_tp(h.to(self.dtype), self.tp.group)
        return gather_from_tp(F.linear(h, w.to(self.dtype)).float(),
                              self.tp.group, -1)

    def embed_concat(self, batch: GatoBatch, deterministic: bool = True,
                     with_targets: bool = True,
                     generator: Optional[torch.Generator] = None):
        """Embed every modality group and concatenate along the batch:
        (h, loss_mask f32, label clamped at 0), the last two None without
        targets. Groups go in ``MODALITY_ORDER``, then other keys sorted; a
        key routes to the embedder of its prefix before "_" ("rl_img" ->
        "rl"), so a mixed batch is ``[rl || nlp || ic || vqa || rl_img
        rows]``. An unknown group key raises ``ValueError`` where the JAX
        package drops it. With ``deterministic=False`` the patch positions
        draw from ``generator``."""
        embs = []
        for name in self._groups(batch):
            base = name.split("_")[0]
            sub = batch[name]
            if base == "nlp":
                embs.append(self.embed_nlp(sub.tokens))
            elif base == "rl":
                embs.append(self.embed_rl(sub.tokens, sub.position_id,
                                          sub.images, deterministic,
                                          generator))
            else:                                       # "ic", "vqa"
                embs.append(self.embed_ic(sub.prompt, sub.images, sub.text,
                                          deterministic, generator))
        h = torch.cat(embs, dim=0) if len(embs) > 1 else embs[0]
        if not with_targets:
            return h, None, None
        return (h, *self.concat_targets(batch))

    @staticmethod
    def _groups(batch: GatoBatch) -> list:
        """The batch's groups that hold rows, in ``embed_concat``'s order;
        an unknown group key raises ``ValueError``."""
        names = [n for n in MODALITY_ORDER if n in batch]
        names += sorted(k for k in batch if k not in MODALITY_ORDER)
        for name in names:
            if name.split("_")[0] not in MODALITY_ORDER:
                raise ValueError(f"unknown modality group {name!r}; the "
                                 f"groups are {MODALITY_ORDER} and their "
                                 "'<group>_<suffix>' sub-groups")
        return [n for n in names if batch[n] is not None]

    def concat_targets(self, batch: GatoBatch) -> Tuple[Tensor, Tensor]:
        """(loss_mask f32, label clamped at 0) of every group, concatenated
        in ``embed_concat``'s order (what a pipeline's last stage needs of
        a batch)."""
        subs = [batch[n] for n in self._groups(batch)]
        return (torch.cat([s.loss_mask for s in subs], dim=0).float(),
                torch.cat([s.label.clamp(min=0) for s in subs], dim=0))

    def loss_from_hidden(self, h: Tensor, loss_mask: Tensor,
                         label: Tensor, count: Optional[Tensor] = None
                         ) -> Tensor:
        """Masked CE from the trunk output, the masked sum over
        max(``count``, 1e-8) (default: the mask's sum); the tied head goes
        through the blockwise fused CE, so the f32 [B, L, V] logits never
        exist."""
        valid = self.layout.total_vocab_size
        if self.cfg.share_input_output_embedding:
            return masked_cross_entropy_fused(
                h, self.word_embedding.weight, label, loss_mask, valid, count,
                self.tp)
        return masked_cross_entropy(self.logits(h), label, loss_mask, valid,
                                    count)

    # ---- full-sequence trunk ----------------------------------------------
    def init_mems(self, batch_size: int) -> Tensor:
        """Zero hidden-state memory [n_layer, B, mem_len, D] in the compute
        dtype."""
        cfg = self.cfg
        return torch.zeros(cfg.n_layer, batch_size, cfg.mem_len, cfg.n_embed,
                           dtype=self.dtype, device=self.device)

    def trunk(self, h: Tensor, mems: Optional[Tensor],
              deterministic: bool = True,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[Tensor, Optional[Tensor]]:
        """Every layer over ``[mems[i] || h]`` (h [B, q, D]; mems
        [n_layer, B, M, D] or None). Returns (h, new mems): the trailing
        mem_len of ``[mems || layer inputs]`` per layer, None without
        mems. With ``deterministic=False`` the dropout sites draw from
        ``generator`` (embedded input and positional embedding, then per
        layer the attention, o_net and FF outputs). With ``cfg.remat`` in
        grad mode each layer is checkpointed (:func:`_remat_layer`). Under
        the sequence-sharded option without mems each rank runs the layers
        on its slice of the sequence, gathered at the end."""
        self._whole_stack()
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        drop = None
        if not deterministic:
            if generator is None:
                raise ValueError("deterministic=False needs the training "
                                 "torch.Generator")
            drop = generator
        qlen = h.shape[1]
        mlen = 0 if mems is None else mems.shape[2]
        klen = mlen + qlen
        dev = h.device
        mask = (same_length_mask(qlen, klen, cfg.mem_len, device=dev)
                if cfg.same_length else causal_mask(qlen, klen, device=dev))
        r = relative_positional_embedding(
            klen, cfg.n_embed, cfg.effective_clamp_len, device=dev)
        if drop is not None:
            h = dropout(h, cfg.embd_pdrop, drop, cfg.dropout_impl)
            r = dropout(r, cfg.embd_pdrop, drop, cfg.dropout_impl)
        use_kernel = use_rel_kernel(
            cfg, qlen, klen, dev,
            use_dropatt=drop is not None and cfg.dropattn > 0.0)
        if mems is None:
            return self.run_layers(h, r, mask, use_kernel, drop), None
        hids = []
        for i, layer in enumerate(self.h):
            mem = mems[i].to(self.dtype)
            hids.append(h)
            if remat:
                h = _remat_layer(layer, h, mem, r, mask, use_kernel, drop)
            else:
                h = layer(h, mem, r, mask, use_kernel, drop)
        cat = torch.cat([mems.to(self.dtype), torch.stack(hids)], dim=2)
        return h, cat[:, :, -cfg.mem_len:]

    def run_layers(self, h: Tensor, r: Tensor, mask: Tensor,
                   use_kernel: bool,
                   drop: Optional[torch.Generator] = None) -> Tensor:
        """The layers this model holds, in order, over h [B, q, D] without
        memory (the trunk's loop; a pipeline stage's share of it):
        checkpointed under ``cfg.remat`` in grad mode, and under the
        sequence-sharded option run on this rank's slice of the sequence,
        gathered at the end."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        tp = self.tp
        sp = tp is not None and tp.sequence_sharded
        if sp:
            qlen = h.shape[1]
            if qlen % tp.size:
                raise ValueError(
                    f"the sequence-sharded trunk splits the sequence over "
                    f"{tp.size} ranks; its length {qlen} does not divide")
            h = scatter_to_tp(h, tp.group, 1)
        for layer in self.h:
            if remat:
                h = _remat_layer(layer, h, None, r, mask, use_kernel, drop)
            else:
                h = layer(h, None, r, mask, use_kernel, drop)
        if sp:
            h = gather_from_tp(h, tp.group, 1)
        return h

    def _whole_stack(self) -> None:
        """``ValueError`` on a pipeline stage, which holds a share of the
        layers: parallel/pipeline.py runs it."""
        if self.pp is not None:
            ids = self.pp.layers(self.cfg.n_layer)
            raise ValueError(
                f"this model is pipeline stage {self.pp.stage}, holding "
                f"layers [{ids.start}, {ids.stop}); parallel/pipeline.py "
                "runs the stages (gather_stages gives stage 0 the whole "
                "model)")

    def forward(self, batch: GatoBatch, mems: Optional[Tensor] = None,
                compute_loss: bool = True, deterministic: bool = True,
                loss_only: bool = False,
                generator: Optional[torch.Generator] = None,
                count_reduce: Optional[Callable[[Tensor], Tensor]] = None):
        """Mixed-modality forward with the JAX package's ``__call__``
        signature and returns: (logits f32 [B, L, V], loss), plus the new
        mems when ``mems`` is given; ``(None, loss)`` with ``loss_only`` and
        a tied head (the fused CE). Follows the caller's grad mode; with
        ``deterministic=False`` dropout draws from ``generator`` (the JAX
        package's "dropout" rng). ``count_reduce`` maps the batch's
        loss-mask count to the count the masked sum is divided by (data
        parallelism: its sum over the ranks, so the loss is this rank's
        share of the global micro-batch's mean)."""
        if compute_loss and mems is not None:
            raise ValueError("training does not use segment memory")
        h, loss_mask, label = self.embed_concat(
            batch, deterministic, with_targets=compute_loss,
            generator=generator)
        count = None
        if compute_loss and count_reduce is not None:
            count = count_reduce(loss_mask.sum())
        h, new_mems = self.trunk(h, mems, deterministic, generator)
        if compute_loss and loss_only and self.cfg.share_input_output_embedding:
            return None, self.loss_from_hidden(h, loss_mask, label, count)
        logits = self.logits(h)
        loss = None
        if compute_loss:
            loss = masked_cross_entropy(logits, label, loss_mask,
                                        self.layout.total_vocab_size, count)
        if mems is not None:
            return logits, loss, new_mems
        return logits, loss

    @torch.no_grad()
    def decode_rl(self, tokens: Tensor, position_id: Tensor, mems: Tensor,
                  images=None) -> Tuple[Tensor, Tensor]:
        """One step over hidden-state memory: tokens/position_id [B, q],
        mems [n_layer, B, mem_len, D], images [B, T, H, W, C] or None ->
        (last-position logits [B, V] f32, new mems)."""
        h, new_mems = self.trunk(self.embed_rl(tokens, position_id, images),
                                 mems)
        return self.logits(h[:, -1]), new_mems

    # ---- ring-cache decode ------------------------------------------------
    def init_kv_cache_ring(self, batch_size: int) -> RingCache:
        """Zero ring K/V cache [n_layer, B, mem_len, H, Dh] in the compute
        dtype (equal to the reference's zero hidden memory for post-LN
        models: QKV has no bias) and cursor 0. With decode_cache_dtype
        "int8" the values are int8 with zero f32 scales [n_layer, B,
        mem_len, H] (zero values times zero scales are the same zero
        cache). A pre-LN model raises ``ValueError``."""
        self._refuse_pre_ln()
        shapes = ring_cache_shardings(self.cfg, batch_size, self.tp)
        dev = self.device
        if self.cfg.decode_cache_dtype == "int8":
            return {**{k: torch.zeros(s, dtype=torch.int8 if k in ("k", "v")
                                      else torch.float32, device=dev)
                       for k, s in shapes.items()}, "cursor": 0}
        return {"k": torch.zeros(shapes["k"], dtype=self.dtype, device=dev),
                "v": torch.zeros(shapes["v"], dtype=self.dtype, device=dev),
                "cursor": 0}

    def _refuse_pre_ln(self) -> None:
        if self.cfg.pre_lnorm:
            raise ValueError(
                "a zero K/V cache equals a zero hidden memory only for "
                "post-LN models (LN(0) is the LayerNorm bias); pre-LN models "
                "decode over hidden-state memory (init_mems, decode_rl)")

    def decode_weights_quantized(self) -> bool:
        return hasattr(self.h[0].dec_attn.qkv_net, "weight_q")

    @torch.no_grad()
    def quantize_decode_weights(self) -> None:
        """Decode-only transform of the loaded weights, in place and
        idempotent: qkv_net, o_net, CoreNet.0 and CoreNet.2 of every layer
        trade their ``weight`` for ``weight_q`` (int8 [N, K]) and
        ``weight_scale`` (f32 [N], per output channel) buffers. r_net (read
        raw by :meth:`precompute_rk`), the embeddings, the head, the
        LayerNorms and the biases keep their dtype. Under tensor
        parallelism the row-parallel matrices (o_net, CoreNet.2) scale each
        output channel by its max over the whole row (over the model
        group), so every rank holds the shard of the one-process int8
        weights."""
        if self.decode_weights_quantized():
            return
        for layer in self.h:
            a, f = layer.dec_attn, layer.pos_ff
            for lin in (a.qkv_net, a.o_net, f.CoreNet[0], f.CoreNet[2]):
                absmax = None
                if self.tp is not None and lin in (a.o_net, f.CoreNet[2]):
                    absmax = all_reduce_max(
                        lin.weight.float().abs().amax(dim=1), self.tp.group)
                w_q, scale = quantize_weight(lin.weight, absmax)
                del lin.weight
                lin.register_buffer("weight_q", w_q)
                lin.register_buffer("weight_scale", scale)

    @torch.no_grad()
    def precompute_rk(self, qlen: int) -> Tensor:
        """Per-layer positional projections [n_layer, M+qlen, H, Dh] in the
        compute dtype (r_net is input-independent)."""
        cfg = self.cfg
        klen = cfg.mem_len + qlen
        r = relative_positional_embedding(
            klen, cfg.n_embed, cfg.effective_clamp_len, dtype=self.dtype,
            device=self.device)
        rk = torch.stack([_dense(r, layer.dec_attn.r_net, self.dtype)
                          for layer in self.h])
        return rk.view(cfg.n_layer, klen, self.heads, cfg.d_head)

    def use_kernels(self, qlen: int, cache: RingCache) -> bool:
        """The ``decode_flash`` gate: the kernel route (CUDA kernels on CUDA
        tensors, their plain versions on the CPU) for 1 <= q <= 32 under
        "on", and under "auto" whenever the kernels take the cache (bf16,
        or int8 with its scales; under tensor parallelism the cache of
        this rank's heads, as the JAX gate judges the heads a shard) and
        the bf16 queries; otherwise the plain ring branch."""
        flash = self.cfg.decode_flash
        if not 1 <= qlen <= MAX_PRIME_Q or flash == "off":
            return False
        if flash == "on":
            return True
        if flash != "auto":
            raise ValueError(f"decode_flash={flash!r}")
        return (self.dtype == torch.bfloat16
                and kernels_take(cache["k"], cache.get("k_scale")))

    def ring_masks(self, qlen: int, cursor: int, device
                   ) -> Tuple[Tensor, Tensor]:
        """(mask [q, M+q] over [memory | new tokens] in age order, mask_s
        its M cache columns rotated into ring order); True is banned."""
        cfg = self.cfg
        M = cfg.mem_len
        mask = (same_length_mask(qlen, M + qlen, M, device=device)
                if cfg.same_length else
                causal_mask(qlen, M + qlen, device=device))
        return mask, torch.roll(mask[:, :M], cursor, dims=-1)

    @torch.no_grad()
    def decode_rl_kv_ring(self, tokens: Tensor, position_id: Tensor,
                          cache: RingCache, rk_full: Tensor,
                          images=None, spec_tail: int = 0,
                          real_q: Optional[int] = None
                          ) -> Tuple[Tensor, RingCache]:
        """One forward of ``q <= mem_len`` RL tokens [B, q] over the ring
        cache; returns (logits [B, V] f32 at the last real token, the cache
        with the real rows' K/V written at the cursor and the cursor
        advanced past them). ``images`` [B, T, H, W, C] fill the prime's -1
        slots. ``real_q`` (a host int, geometry buckets) marks the first
        ``real_q`` rows as the real tokens and the rest as query-only pads;
        ``spec_tail`` marks the trailing rows (or, with ``real_q``, the
        rows right after the real ones) as speculative guesses: see
        :meth:`ring_forward`."""
        return self.ring_forward(self.embed_rl(tokens, position_id, images),
                                 cache, rk_full, real_q, spec_tail)

    def ring_forward(self, h: Tensor, cache: RingCache, rk_full: Tensor,
                     real_q: Optional[int] = None, spec_tail: int = 0
                     ) -> Tuple[Tensor, RingCache]:
        """Every layer over the ring cache for embedded tokens h [B, q, D]
        (q <= mem_len; rk_full [n_layer, M+q, H, Dh]). The cache tensors
        are updated in place; an int8 cache stores the rows quantized, with
        their scales. With ``real_q`` only the first ``real_q`` rows are
        written, at (cursor + t) % M, the logits come from row real_q - 1
        and the cursor advances by real_q: the pad rows after them attend
        but are never committed, so the slots they would take (the oldest
        rows, which the next forward still attends) keep their values. The
        real rows come first and the attention is causal, so they never see
        the pads, and the masks are row-index arithmetic: the real rows'
        outputs equal an unpadded forward's. A pipeline stage raises.

        ``spec_tail`` S > 0 (speculative decode) makes the last S rows, or
        with ``real_q`` the S rows after the real ones ([real || guesses ||
        pads]), query-only guesses: they attend as any row does (to the
        real rows and the earlier guesses of this call too) but are not
        written, and the cursor advances past the real rows only. The
        logits are then those of every row from the last committed one on:
        [B, S + 1, V], or [B, q, V] when nothing commits (q == S: a verify
        forward, which returns the cache untouched)."""
        self._whole_stack()
        cfg = self.cfg
        M = cfg.mem_len
        qlen = h.shape[1]
        if qlen > M:
            raise ValueError(f"a ring forward takes q <= mem_len ({M}), "
                             f"got {qlen}")
        n = qlen - spec_tail if real_q is None else int(real_q)
        if not (0 if real_q is None else 1) <= n <= qlen - spec_tail:
            raise ValueError(f"real_q={real_q}, spec_tail={spec_tail} do "
                             f"not fit q={qlen}")
        cursor = int(cache["cursor"])
        dev = cache["k"].device
        mask, mask_s = self.ring_masks(qlen, cursor, dev)
        use_kernels = self.use_kernels(qlen, cache)
        quantized = "k_scale" in cache
        idx = None if n <= 1 else (torch.arange(n, device=dev) + cursor) % M
        for li, layer in enumerate(self.h):
            h, k_x, v_x = layer.forward_ring(
                h, rk_full[li], cache, li, mask, mask_s, use_kernels)
            if not n:
                continue
            rows = {"k": k_x[:, :n], "v": v_x[:, :n]}
            if quantized:
                for key in ("k", "v"):
                    rows[key], rows[key + "_scale"] = quantize_kv_rows(
                        rows[key])
            # write the n real rows at (cursor + t) % M: a one-row write
            # never wraps and is a slice assignment
            for key, new in rows.items():
                if n == 1:
                    cache[key][li, :, cursor] = new[:, 0]
                else:
                    cache[key][li].index_copy_(1, idx, new)
        if not spec_tail:
            return self.logits(h[:, n - 1]), {**cache,
                                              "cursor": (cursor + n) % M}
        if not n:                       # a verify forward commits nothing
            return self.logits(h), cache
        logits = self.logits(h[:, n - 1:n + spec_tail])
        return logits, {**cache, "cursor": (cursor + n) % M}

    def align_ring_cache(self, cache: RingCache) -> RingCache:
        """The ring rotated back to age order (oldest at slot 0), cursor 0,
        as :meth:`decode_rl_kv` takes it."""
        shift = -int(cache["cursor"])
        out = {k: torch.roll(v, shift, dims=2) for k, v in cache.items()
               if k != "cursor"}
        return {**out, "cursor": 0}

    def init_kv_cache(self, batch_size: int) -> RingCache:
        """Zero aligned K/V cache [n_layer, B, mem_len, H, Dh] in the
        compute dtype, cursor 0 (whatever ``decode_cache_dtype`` says, as
        the JAX package's ``init_kv_cache``): the cache of the caption, VQA
        and text generators. Read as a ring it is at cursor 0. A pre-LN
        model raises ``ValueError``."""
        self._refuse_pre_ln()
        shape = ring_cache_shardings(self.cfg, batch_size, self.tp)["k"]
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "cursor": 0}

    @torch.no_grad()
    def decode_rl_kv(self, tokens: Tensor, position_id: Tensor,
                     cache: RingCache, rk: Tensor, images=None
                     ) -> Tuple[Tensor, RingCache]:
        """One forward of any q RL tokens over an aligned K/V cache (cursor
        0, oldest first, in the compute dtype): the JAX package's
        ``decode_rl_kv``, taken by a prime longer than mem_len that the
        ring cannot scatter in one call. See :meth:`kv_forward`."""
        return self.kv_forward(self.embed_rl(tokens, position_id, images),
                               cache, rk)

    def kv_forward(self, h: Tensor, cache: RingCache,
                   rk: Optional[Tensor] = None) -> Tuple[Tensor, RingCache]:
        """Every layer over an aligned K/V cache for embedded tokens h [B,
        q, D], any q: the JAX package's ``trunk_kv``. rk [n_layer, M+q, H,
        Dh] (made here when None). Each layer attends over [cache || new
        rows] by the trunk's route (:func:`use_rel_kernel`: K3 on the
        card), and its cache becomes the trailing mem_len rows of them.
        Returns (last-position logits [B, V] f32, the new aligned cache,
        cursor 0). A pipeline stage raises."""
        self._whole_stack()
        cfg = self.cfg
        M = cfg.mem_len
        qlen = h.shape[1]
        klen = cache["k"].shape[2] + qlen
        if rk is None:
            rk = self.precompute_rk(qlen)
        dev = h.device
        mask = (same_length_mask(qlen, klen, M, device=dev)
                if cfg.same_length else causal_mask(qlen, klen, device=dev))
        use_kernel = use_rel_kernel(cfg, qlen, klen, dev)
        new = {"k": [], "v": []}
        for li, layer in enumerate(self.h):
            h, k_x, v_x = layer.forward_kv(h, rk[li], cache["k"][li],
                                           cache["v"][li], mask, use_kernel)
            for key, rows in (("k", k_x), ("v", v_x)):
                new[key].append(torch.cat(
                    [cache[key][li], rows.to(cache[key].dtype)], 1)[:, -M:])
        return (self.logits(h[:, -1]),
                {"k": torch.stack(new["k"]), "v": torch.stack(new["v"]),
                 "cursor": 0})

    def _aligned(self, cache: RingCache) -> RingCache:
        if "k_scale" in cache:
            raise ValueError("the text and caption generators take the "
                             "compute-dtype cache of init_kv_cache, not an "
                             "int8 ring")
        return self.align_ring_cache(cache) if int(cache["cursor"]) else cache

    @torch.no_grad()
    def prime_ic_kv(self, prompt: Tensor, images: Tensor, text: Tensor,
                    cache: RingCache, rk: Optional[Tensor] = None
                    ) -> Tuple[Tensor, RingCache]:
        """Fold a [prompt | image patches | text] prefix (prompt [B, P],
        images [B, H, W, C], text [B, T]) into the K/V cache over the
        aligned route (K3 on the card): (last-position logits [B, V] f32,
        the new cache at cursor 0, which :meth:`decode_text_kv` continues
        as a ring)."""
        h = self.embed_ic(prompt, images, text, deterministic=True)
        return self.kv_forward(h, self._aligned(cache), rk)

    @torch.no_grad()
    def decode_text_kv(self, tokens: Tensor, cache: RingCache,
                       rk: Optional[Tensor] = None
                       ) -> Tuple[Tensor, RingCache]:
        """Text tokens [B, q] (the word embedding alone, no timestep term)
        over the K/V cache: (last-position logits [B, V] f32, the new
        cache). rk [n_layer, M+q, H, Dh] (made here when None). Up to
        ``MAX_PRIME_Q`` tokens take the ring (K1 at q == 1, K2 above, on
        the card): the cache keeps exactly M rows, so a ring forward sees
        the keys that the JAX package's ``trunk_kv`` over [cache || new]
        sees, and writing over the oldest rows leaves its trailing M. A
        longer prompt takes the aligned route (K3 on the card)."""
        h = self.embed_nlp(tokens)
        if rk is None:
            rk = self.precompute_rk(tokens.shape[1])
        if tokens.shape[1] <= min(MAX_PRIME_Q, self.cfg.mem_len):
            return self.ring_forward(h, cache, rk)
        return self.kv_forward(h, self._aligned(cache), rk)
