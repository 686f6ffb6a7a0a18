"""TransformerXL decoder: the RL subset of bdm_db1_tpu/models/transformer_xl.py
(ring-cache decode, the full-sequence trunk with hidden-state memory, the
loss and ``decode_rl``).

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

Not ported yet (raise ``NotImplementedError``): images and modalities
other than RL, rematerialization (``remat``), pre-LN models, the
speculative tail and geometry-bucket padding.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bdm_db1_tpu_torch.core.config import ModelConfig, VocabConfig
from bdm_db1_tpu_torch.data.input_specs import MODALITY_ORDER, GatoBatch
from bdm_db1_tpu_torch.models.activations import ACT2FN
from bdm_db1_tpu_torch.ops.attention import (
    causal_mask, rel_attention, rel_shift, rel_shift_sliced, same_length_mask,
)
from bdm_db1_tpu_torch.ops.fast_dropout import dropout
from bdm_db1_tpu_torch.ops.flash_rel_attention import (
    flash_rel_attention, kernel_route_applicable,
)
from bdm_db1_tpu_torch.ops.flash_ring_decode import (
    MAX_PRIME_Q, NEG_INF, combine_new_columns, combine_self_column,
    flash_ring_decode, flash_ring_prime_ap, kernels_take,
)
from bdm_db1_tpu_torch.ops.fused_ce import masked_cross_entropy_fused
from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding
from bdm_db1_tpu_torch.ops.quant_matmul import (
    quant_matmul, quantize_weight, w8a8_matmul,
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
    K3-K5 versions on the CPU), and under "auto" when the tensors are on
    CUDA."""
    if (cfg.attention_impl == "xla" or use_dropatt
            or not kernel_route_applicable(qlen, klen)):
        return False
    if cfg.attention_impl == "pallas":
        return True
    return torch.device(device).type == "cuda"


def masked_cross_entropy(logits: Tensor, labels: Tensor, loss_mask: Tensor,
                         valid_vocab: int) -> Tensor:
    """Masked mean CE in f32; the vocab tail from ``valid_vocab`` on is out
    of the softmax."""
    v = logits.shape[-1]
    if valid_vocab < v:
        pad_bias = torch.where(
            torch.arange(v, device=logits.device) < valid_vocab, 0.0, -1e30)
        logits = logits + pad_bias
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return (nll * loss_mask).sum() / torch.clamp(loss_mask.sum(), min=1e-8)


def _layer_norm(x: Tensor, ln: nn.LayerNorm) -> Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                        ln.bias.to(x.dtype), ln.eps)


class PositionalEmbedding(nn.Module):
    """Holds the reference's sinusoidal ``inv_freq`` buffer; decode builds
    the embedding itself (ops/positional.py)."""

    def __init__(self, d_model: int, device):
        super().__init__()
        self.register_buffer("inv_freq", 1.0 / (10000.0 ** (
            torch.arange(0.0, d_model, 2.0, device=device) / d_model)))


class RelMultiHeadAttn(nn.Module):
    """Relative multi-head attention with fused QKV, post-LN residual."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        d, h, dh = cfg.n_embed, cfg.n_head, cfg.d_head
        self.qkv_net = _linear(d, 3 * d, False, device, dtype)
        self.r_net = _linear(d, d, False, device, dtype)
        self.o_net = _linear(d, d, False, device, dtype)
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_epsilon,
                                       device=device, dtype=dtype)
        if cfg.untie_r:
            self.r_w_bias = nn.Parameter(torch.empty(h, dh, device=device,
                                                     dtype=dtype))
            self.r_r_bias = nn.Parameter(torch.empty(h, dh, device=device,
                                                     dtype=dtype))

    def _residual(self, x: Tensor, attn: Tensor,
                  drop: Optional[torch.Generator] = None) -> Tensor:
        """o_net (then dropout at ``cfg.drop`` when ``drop``, the training
        generator, is given), then the post-LN residual with the DeepNorm
        alpha."""
        cfg = self.cfg
        b, qlen = x.shape[:2]
        out = _dense(attn.to(x.dtype).reshape(b, qlen, cfg.n_embed),
                     self.o_net, x.dtype, _a8(cfg))
        if drop is not None:
            out = dropout(out, cfg.drop, drop, cfg.dropout_impl)
        alpha = (2 * cfg.n_layer) ** 0.25 if cfg.use_deepnorm else 1.0
        return _layer_norm(x * alpha + out, self.layer_norm)

    def forward(self, x: Tensor, r: Tensor, mem: Optional[Tensor],
                mask: Tensor, use_kernel: bool,
                drop: Optional[torch.Generator] = None) -> Tensor:
        """One layer over ``[mem || x]`` (hidden states; mem [B, M, D] or
        None): x [B, q, D], r [M+q, D] positional embeddings, mask [q, M+q]
        (True = banned). ``drop`` is the training generator (None:
        deterministic). Returns the post-LN output [B, q, D]."""
        return self._residual(
            x, self.attend(x, r, mem, mask, use_kernel, drop), drop)

    def attend(self, x: Tensor, r: Tensor, mem: Optional[Tensor],
               mask: Tensor, use_kernel: bool,
               drop: Optional[torch.Generator] = None) -> Tensor:
        """The attention part of :meth:`forward`: [B, q, H, Dh] before o_net.
        QKV runs over ``[mem || x]``; q is its last q rows; r_net projects
        r in the compute dtype; ``use_kernel`` picks K3-K5 (with f32 biases,
        as the JAX kernel route takes them) or ``rel_attention``, which
        applies the attention dropout (``cfg.dropattn``) when ``drop`` is
        given."""
        cfg = self.cfg
        h, dh = cfg.n_head, cfg.d_head
        dtype = x.dtype
        qlen = x.shape[1]
        cat = x if mem is None else torch.cat([mem.to(dtype), x], dim=1)
        klen = cat.shape[1]
        q, k, v = _dense(cat, self.qkv_net, dtype, _a8(cfg)).split(
            cfg.n_embed, dim=-1)
        q = q[:, -qlen:].unflatten(-1, (h, dh))
        k, v = k.unflatten(-1, (h, dh)), v.unflatten(-1, (h, dh))
        r_k = _dense(r.to(dtype), self.r_net, dtype).view(klen, h, dh)
        if use_kernel:
            return flash_rel_attention(
                q, k, v, r_k, self.r_w_bias.float(), self.r_r_bias.float(),
                mem_len=cfg.mem_len, same_length=cfg.same_length,
                scale=1.0 / dh ** 0.5).to(dtype)
        rate = cfg.dropattn if drop is not None else 0.0
        return rel_attention(q, k, v, r_k, self.r_w_bias, self.r_r_bias,
                             mask, compute_dtype=dtype, dropout_rate=rate,
                             generator=drop)

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
        h, dh = cfg.n_head, cfg.d_head
        dtype = x.dtype
        b, qlen = x.shape[:2]
        k_cache, v_cache = cache["k"], cache["v"]
        k_scale, v_scale = cache.get("k_scale"), cache.get("v_scale")
        cursor = int(cache["cursor"])
        M = k_cache.shape[2]
        r_w, r_r = self.r_w_bias, self.r_r_bias
        q, k_x, v_x = _dense(x, self.qkv_net, dtype, _a8(cfg)).view(
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
    between them) with the post-LN residual and DeepNorm alpha."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        d_mid = cfg.d_inner // (2 if cfg.activation_fn == "geglu" else 1)
        self.CoreNet = nn.Sequential(
            _linear(cfg.n_embed, cfg.d_inner, True, device, dtype),
            Activation(cfg.activation_fn),
            _linear(d_mid, cfg.n_embed, True, device, dtype))
        self.layer_norm = nn.LayerNorm(cfg.n_embed,
                                       eps=cfg.layer_norm_epsilon,
                                       device=device, dtype=dtype)

    def forward(self, x: Tensor,
                drop: Optional[torch.Generator] = None) -> Tensor:
        wi, act, wo = self.CoreNet
        a8 = _a8(self.cfg)
        h = _dense(act(_dense(x, wi, x.dtype, a8)), wo, x.dtype, a8)
        if drop is not None:
            h = dropout(h, self.cfg.drop, drop, self.cfg.dropout_impl)
        alpha = (2 * self.cfg.n_layer) ** 0.25 if self.cfg.use_deepnorm \
            else 1.0
        return _layer_norm(x * alpha + h, self.layer_norm)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.dec_attn = RelMultiHeadAttn(cfg, device, dtype)
        self.pos_ff = PositionwiseFF(cfg, device, dtype)

    def forward(self, h: Tensor, mem: Optional[Tensor], r: Tensor,
                mask: Tensor, use_kernel: bool,
                drop: Optional[torch.Generator] = None) -> Tensor:
        """Attention over ``[mem || h]``, then the FF; ``drop`` is the
        training generator (None: deterministic)."""
        return self.pos_ff(self.dec_attn(h, r, mem, mask, use_kernel, drop),
                           drop)

    def forward_ring(self, x, rk, cache, layer, mask, mask_s, use_kernels):
        h, k_x, v_x = self.dec_attn.forward_ring(
            x, rk, cache, layer, mask, mask_s, use_kernels)
        return self.pos_ff(h), k_x, v_x


class TransformerXL(nn.Module):
    """The decoder. ``device`` defaults to the card and CUDA is never
    swapped for the CPU: asking for it where there is none raises. Weights
    are drawn from ``generator`` (normal(0.02) matrices and embeddings,
    zero biases, unit LayerNorm scales) directly in ``cfg.param_dtype`` on
    that device."""

    def __init__(self, cfg: ModelConfig, vocab: VocabConfig, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.pre_lnorm:
            raise NotImplementedError("pre-LN models are not ported yet")
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
        self.layout = vocab.layout()
        self.dtype = getattr(torch, cfg.dtype)
        pdt = getattr(torch, cfg.param_dtype)
        d = cfg.n_embed
        V = self.layout.padded_vocab_size
        self.word_embedding = torch.nn.utils.skip_init(
            nn.Embedding, V, d, device=dev, dtype=pdt)
        self.rl_local_timestep_embedding = torch.nn.utils.skip_init(
            nn.Embedding, cfg.rl_timestep_vocab_size, d, device=dev,
            dtype=pdt)
        self.pos_emb = PositionalEmbedding(d, dev)
        if not cfg.untie_r:
            self.r_w_bias = nn.Parameter(
                torch.empty(cfg.n_head, cfg.d_head, device=dev, dtype=pdt))
            self.r_r_bias = nn.Parameter(
                torch.empty(cfg.n_head, cfg.d_head, device=dev, dtype=pdt))
        self.h = nn.ModuleList(
            DecoderLayer(cfg, dev, pdt) for _ in range(cfg.n_layer))
        if not cfg.untie_r:
            for layer in self.h:  # one shared pair, listed under every layer
                layer.dec_attn.r_w_bias = self.r_w_bias
                layer.dec_attn.r_r_bias = self.r_r_bias
        if not cfg.share_input_output_embedding:
            self.lm_head = _linear(d, V, False, dev, pdt)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.word_embedding.weight.device

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg

        def normal(p):
            p.normal_(0.0, INIT_STD, generator=gen)

        normal(self.word_embedding.weight)
        normal(self.rl_local_timestep_embedding.weight)
        if not cfg.untie_r:
            normal(self.r_w_bias)
            normal(self.r_r_bias)
        for layer in self.h:
            a, f = layer.dec_attn, layer.pos_ff
            if cfg.untie_r:
                normal(a.r_w_bias)
                normal(a.r_r_bias)
            for lin in (a.qkv_net, a.r_net, a.o_net, f.CoreNet[0],
                        f.CoreNet[2]):
                normal(lin.weight)
            for lin in (f.CoreNet[0], f.CoreNet[2]):
                lin.bias.zero_()
            for ln in (a.layer_norm, f.layer_norm):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        if not cfg.share_input_output_embedding:
            normal(self.lm_head.weight)

    # ---- embedding and head -------------------------------------------------
    def embed_rl(self, tokens: Tensor, position_id: Tensor) -> Tensor:
        emb = F.embedding(tokens, self.word_embedding.weight).to(self.dtype)
        return emb + F.embedding(
            position_id, self.rl_local_timestep_embedding.weight
        ).to(self.dtype)

    def logits(self, h: Tensor) -> Tensor:
        w = (self.word_embedding.weight if self.cfg.share_input_output_embedding
             else self.lm_head.weight)
        return F.linear(h.to(self.dtype), w.to(self.dtype)).float()

    def embed_concat(self, batch: GatoBatch, deterministic: bool = True,
                     with_targets: bool = True):
        """Embed every modality group and concatenate along the batch:
        (h, loss_mask f32, label clamped at 0), the last two None without
        targets. Groups go in ``MODALITY_ORDER``, then other keys sorted; a
        key routes to the embedder of its prefix before "_" ("rl_img" ->
        "rl"). Only RL groups without images are ported (others raise
        ``NotImplementedError``), and an unknown group key raises
        ``ValueError`` where the JAX package drops it."""
        names = [n for n in MODALITY_ORDER if n in batch]
        names += sorted(k for k in batch if k not in MODALITY_ORDER)
        embs, masks, labels = [], [], []
        for name in names:
            base = name.split("_")[0]
            if base not in MODALITY_ORDER:
                raise ValueError(f"unknown modality group {name!r}; the "
                                 f"groups are {MODALITY_ORDER} and their "
                                 "'<group>_<suffix>' sub-groups")
            sub = batch[name]
            if sub is None:
                continue
            if base != "rl" or sub.images is not None:
                raise NotImplementedError(
                    f"group {name!r}: only RL batches without images are "
                    "ported")
            embs.append(self.embed_rl(sub.tokens, sub.position_id))
            if with_targets:
                masks.append(sub.loss_mask)
                labels.append(sub.label.clamp(min=0))
        h = torch.cat(embs, dim=0) if len(embs) > 1 else embs[0]
        if not with_targets:
            return h, None, None
        return h, torch.cat(masks, dim=0).float(), torch.cat(labels, dim=0)

    def loss_from_hidden(self, h: Tensor, loss_mask: Tensor,
                         label: Tensor) -> Tensor:
        """Masked CE from the trunk output; the tied head goes through the
        blockwise fused CE, so the f32 [B, L, V] logits never exist."""
        valid = self.layout.total_vocab_size
        if self.cfg.share_input_output_embedding:
            return masked_cross_entropy_fused(
                h, self.word_embedding.weight, label, loss_mask, valid)
        return masked_cross_entropy(self.logits(h), label, loss_mask, valid)

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
        layer the attention, o_net and FF outputs)."""
        cfg = self.cfg
        if cfg.remat and torch.is_grad_enabled():
            raise NotImplementedError(
                "rematerialization (remat=True) is not ported yet")
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
        hids = []
        for i, layer in enumerate(self.h):
            mem = None
            if mems is not None:
                mem = mems[i].to(self.dtype)
                hids.append(h)
            h = layer(h, mem, r, mask, use_kernel, drop)
        if mems is None:
            return h, None
        cat = torch.cat([mems.to(self.dtype), torch.stack(hids)], dim=2)
        return h, cat[:, :, -cfg.mem_len:]

    def forward(self, batch: GatoBatch, mems: Optional[Tensor] = None,
                compute_loss: bool = True, deterministic: bool = True,
                loss_only: bool = False,
                generator: Optional[torch.Generator] = None):
        """Mixed-modality forward with the JAX package's ``__call__``
        signature and returns: (logits f32 [B, L, V], loss), plus the new
        mems when ``mems`` is given; ``(None, loss)`` with ``loss_only`` and
        a tied head (the fused CE). Follows the caller's grad mode; with
        ``deterministic=False`` dropout draws from ``generator`` (the JAX
        package's "dropout" rng)."""
        if compute_loss and mems is not None:
            raise ValueError("training does not use segment memory")
        h, loss_mask, label = self.embed_concat(
            batch, deterministic, with_targets=compute_loss)
        h, new_mems = self.trunk(h, mems, deterministic, generator)
        if compute_loss and loss_only and self.cfg.share_input_output_embedding:
            return None, self.loss_from_hidden(h, loss_mask, label)
        logits = self.logits(h)
        loss = None
        if compute_loss:
            loss = masked_cross_entropy(logits, label, loss_mask,
                                        self.layout.total_vocab_size)
        if mems is not None:
            return logits, loss, new_mems
        return logits, loss

    @torch.no_grad()
    def decode_rl(self, tokens: Tensor, position_id: Tensor, mems: Tensor,
                  images=None) -> Tuple[Tensor, Tensor]:
        """One step over hidden-state memory: tokens/position_id [B, q],
        mems [n_layer, B, mem_len, D] -> (last-position logits [B, V] f32,
        new mems)."""
        if images is not None:
            raise NotImplementedError("image observations are not ported yet")
        h, new_mems = self.trunk(self.embed_rl(tokens, position_id), mems)
        return self.logits(h[:, -1]), new_mems

    # ---- ring-cache decode ------------------------------------------------
    def init_kv_cache_ring(self, batch_size: int) -> RingCache:
        """Zero ring K/V cache [n_layer, B, mem_len, H, Dh] in the compute
        dtype (equal to the reference's zero hidden memory for post-LN
        models: QKV has no bias) and cursor 0. With decode_cache_dtype
        "int8" the values are int8 with zero f32 scales [n_layer, B,
        mem_len, H] (zero values times zero scales are the same zero
        cache)."""
        cfg = self.cfg
        shape = (cfg.n_layer, batch_size, cfg.mem_len, cfg.n_head, cfg.d_head)
        dev = self.device
        if cfg.decode_cache_dtype == "int8":
            return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=dev),
                    "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=dev),
                    "cursor": 0}
        return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev),
                "cursor": 0}

    def decode_weights_quantized(self) -> bool:
        return hasattr(self.h[0].dec_attn.qkv_net, "weight_q")

    @torch.no_grad()
    def quantize_decode_weights(self) -> None:
        """Decode-only transform of the loaded weights, in place and
        idempotent: qkv_net, o_net, CoreNet.0 and CoreNet.2 of every layer
        trade their ``weight`` for ``weight_q`` (int8 [N, K]) and
        ``weight_scale`` (f32 [N], per output channel) buffers. r_net (read
        raw by :meth:`precompute_rk`), the embeddings, the head, the
        LayerNorms and the biases keep their dtype."""
        if self.decode_weights_quantized():
            return
        for layer in self.h:
            a, f = layer.dec_attn, layer.pos_ff
            for lin in (a.qkv_net, a.o_net, f.CoreNet[0], f.CoreNet[2]):
                w_q, scale = quantize_weight(lin.weight)
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
        return rk.view(cfg.n_layer, klen, cfg.n_head, cfg.d_head)

    def use_kernels(self, qlen: int, cache: RingCache) -> bool:
        """The ``decode_flash`` gate: the kernel route (CUDA kernels on CUDA
        tensors, their plain versions on the CPU) for 1 <= q <= 32 under
        "on", and under "auto" whenever the kernels take the cache (bf16,
        or int8 with its scales) and the bf16 queries; otherwise the plain
        ring branch."""
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
                          images=None, spec_tail: int = 0, real_q=None
                          ) -> Tuple[Tensor, RingCache]:
        """One forward of ``q <= mem_len`` tokens [B, q] over the ring
        cache; returns (last-position logits [B, V] f32, the cache with the
        q new K/V rows written at the cursor and the cursor advanced). The
        cache tensors are updated in place; an int8 cache stores the rows
        quantized, with their scales."""
        if images is not None or spec_tail or real_q is not None:
            raise NotImplementedError(
                "images, speculative tails and geometry buckets are not "
                "ported yet")
        cfg = self.cfg
        M = cfg.mem_len
        qlen = tokens.shape[1]
        if qlen > M:
            raise ValueError(f"a ring forward takes q <= mem_len ({M}), "
                             f"got {qlen}")
        cursor = int(cache["cursor"])
        dev = cache["k"].device
        h = self.embed_rl(tokens, position_id)
        mask, mask_s = self.ring_masks(qlen, cursor, dev)
        use_kernels = self.use_kernels(qlen, cache)
        quantized = "k_scale" in cache
        idx = (None if qlen == 1 else
               (torch.arange(qlen, device=dev) + cursor) % M)
        for li, layer in enumerate(self.h):
            h, k_x, v_x = layer.forward_ring(
                h, rk_full[li], cache, li, mask, mask_s, use_kernels)
            rows = {"k": k_x, "v": v_x}
            if quantized:
                for key in ("k", "v"):
                    rows[key], rows[key + "_scale"] = quantize_kv_rows(
                        rows[key])
            # write the q new rows at (cursor + t) % M: a q == 1 write never
            # wraps and is a slice assignment
            for key, new in rows.items():
                if qlen == 1:
                    cache[key][li, :, cursor] = new[:, 0]
                else:
                    cache[key][li].index_copy_(1, idx, new)
        logits = self.logits(h[:, -1])
        return logits, {**cache, "cursor": (cursor + qlen) % M}
