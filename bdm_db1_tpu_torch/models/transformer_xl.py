"""TransformerXL decoder, the RL ring-cache decode subset of
bdm_db1_tpu/models/transformer_xl.py.

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
by layer after that layer's attention has read the cache.

Not ported yet (raise ``NotImplementedError``): images, the int8 cache,
quantized weights, the speculative tail, geometry-bucket padding and the
hidden-state (pre-LN) memory path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bdm_db1_tpu_torch.core.config import ModelConfig, VocabConfig
from bdm_db1_tpu_torch.models.activations import ACT2FN
from bdm_db1_tpu_torch.ops.attention import (
    causal_mask, rel_shift, rel_shift_sliced, same_length_mask,
)
from bdm_db1_tpu_torch.ops.flash_ring_decode import (
    MAX_PRIME_Q, NEG_INF, combine_new_columns, combine_self_column,
    flash_ring_decode, flash_ring_prime, kernels_take,
)
from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding

Tensor = torch.Tensor
INIT_STD = 0.02

RingCache = Dict[str, object]   # {"k": Tensor, "v": Tensor, "cursor": int}


def _linear(d_in: int, d_out: int, bias: bool, device, dtype) -> nn.Linear:
    return torch.nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias,
                                    device=device, dtype=dtype)


def _dense(x: Tensor, lin: nn.Linear, dtype) -> Tensor:
    """y = x @ W^T (+ b) in the compute dtype, as the JAX Dense promotes."""
    b = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), b)


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

    def forward_ring(self, x: Tensor, rk: Tensor, k_cache: Tensor,
                     v_cache: Tensor, layer: int, cursor: int,
                     mask: Tensor, mask_s: Tensor, use_kernels: bool
                     ) -> Tuple[Tensor, Tensor, Tensor]:
        """One layer over the ring cache. x [B, q, D]; rk [M+q, H, Dh]
        this layer's positional projections; mask [q, M+q] aligned, mask_s
        its cache columns rotated into ring order. Returns (out, k_x, v_x),
        the new tokens' K/V rows [B, q, H, Dh] in the compute dtype."""
        attn, k_x, v_x = self.attend_ring(x, rk, k_cache, v_cache, layer,
                                          cursor, mask, mask_s, use_kernels)
        cfg = self.cfg
        b, qlen = x.shape[:2]
        out = _dense(attn.to(x.dtype).reshape(b, qlen, cfg.n_embed),
                     self.o_net, x.dtype)
        alpha = (2 * cfg.n_layer) ** 0.25 if cfg.use_deepnorm else 1.0
        return _layer_norm(x * alpha + out, self.layer_norm), k_x, v_x

    def attend_ring(self, x: Tensor, rk: Tensor, k_cache: Tensor,
                    v_cache: Tensor, layer: int, cursor: int, mask: Tensor,
                    mask_s: Tensor, use_kernels: bool
                    ) -> Tuple[Tensor, Tensor, Tensor]:
        """The attention part of :meth:`forward_ring`: (attn [B, q, H, Dh]
        before o_net, k_x, v_x). It reads the cache and writes nothing."""
        cfg = self.cfg
        h, dh = cfg.n_head, cfg.d_head
        dtype = x.dtype
        b, qlen = x.shape[:2]
        M = k_cache.shape[2]
        r_w, r_r = self.r_w_bias, self.r_r_bias
        q, k_x, v_x = _dense(x, self.qkv_net, dtype).view(
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
                k_cache, v_cache, qw0.to(dtype), bias, layer, scale=scale)
            # distance-0 self column (never masked at q == 1)
            s_x = ((qw0 * k_x[:, 0].float()).sum(-1) + bd[..., M]) * scale
            attn = combine_self_column(o_un, m_s, l_s, s_x, v_x[:, 0])[:, None]
        elif use_kernels:
            bd = rel_shift_sliced(torch.einsum("bihd,jhd->bhij", qr, rkf))
            bd_s = torch.roll(bd[..., :M], cursor, dims=-1)
            bias = torch.where(mask_s, NEG_INF, bd_s * scale)
            o_un, m_s, l_s = flash_ring_prime(
                k_cache, v_cache, qw.transpose(1, 2).to(dtype).contiguous(),
                bias, layer, scale=scale)
            # the new tokens' q x q block, causal among themselves
            ac_x = torch.einsum("bihd,bjhd->bhij", qw, k_x.float())
            s_new = torch.where(mask[:, M:], NEG_INF,
                                (ac_x + bd[..., M:]) * scale)
            attn = combine_new_columns(o_un, m_s, l_s, s_new, v_x,
                                       compute_dtype=dtype)
        else:
            attn = self._plain_ring(qw, qr, k_x, v_x, rkf, k_cache[layer],
                                    v_cache[layer], cursor, mask, mask_s,
                                    scale, dtype)
        return attn, k_x, v_x

    @staticmethod
    def _plain_ring(qw, qr, k_x, v_x, rkf, k_c, v_c, cursor, mask, mask_s,
                    scale, dtype) -> Tensor:
        """The plain ring branch: full f32 scores over [ring cache | new
        tokens], masked softmax, PV in the compute dtype. [B, q, H, Dh]."""
        M = k_c.shape[1]
        qlen = qw.shape[1]
        ac_s = torch.einsum("bihd,bjhd->bhij", qw, k_c.float())
        ac_x = torch.einsum("bihd,bjhd->bhij", qw, k_x.float())
        bd = torch.einsum("bihd,jhd->bhij", qr, rkf)           # [B,H,q,M+q]
        # small q: the sliced shift (differs only in always-masked columns)
        bd = rel_shift_sliced(bd) if qlen <= 64 else rel_shift(bd)
        bd_s = torch.roll(bd[..., :M], cursor, dims=-1)
        scores = torch.cat([ac_s + bd_s, ac_x + bd[..., M:]], dim=-1) * scale
        mask_ring = torch.cat([mask_s, mask[:, M:]], dim=-1)
        scores = torch.where(mask_ring, NEG_INF, scores)
        probs = torch.softmax(scores, dim=-1).to(dtype)
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

    def forward(self, x: Tensor) -> Tensor:
        wi, act, wo = self.CoreNet
        h = _dense(act(_dense(x, wi, x.dtype)), wo, x.dtype)
        alpha = (2 * self.cfg.n_layer) ** 0.25 if self.cfg.use_deepnorm \
            else 1.0
        return _layer_norm(x * alpha + h, self.layer_norm)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.dec_attn = RelMultiHeadAttn(cfg, device, dtype)
        self.pos_ff = PositionwiseFF(cfg, device, dtype)

    def forward_ring(self, x, rk, k_cache, v_cache, layer, cursor, mask,
                     mask_s, use_kernels):
        h, k_x, v_x = self.dec_attn.forward_ring(
            x, rk, k_cache, v_cache, layer, cursor, mask, mask_s,
            use_kernels)
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
            raise NotImplementedError(
                "pre-LN models decode through hidden-state memory, which is "
                "not ported yet")
        for name, val in (("decode_cache_dtype", cfg.decode_cache_dtype),
                          ("decode_weight_dtype", cfg.decode_weight_dtype)):
            if val:
                raise NotImplementedError(f"{name}={val!r} is not ported yet")
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

    # ---- ring-cache decode ------------------------------------------------
    def init_kv_cache_ring(self, batch_size: int) -> RingCache:
        """Zero ring K/V cache [n_layer, B, mem_len, H, Dh] in the compute
        dtype (equal to the reference's zero hidden memory for post-LN
        models: QKV has no bias) and cursor 0."""
        cfg = self.cfg
        shape = (cfg.n_layer, batch_size, cfg.mem_len, cfg.n_head, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "cursor": 0}

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

    def use_kernels(self, qlen: int, k_cache: Tensor) -> bool:
        """The ``decode_flash`` gate: the kernel route (CUDA kernels on CUDA
        tensors, their plain versions on the CPU) for 1 <= q <= 32 under
        "on", and under "auto" whenever the kernels take the cache;
        otherwise the plain ring branch."""
        flash = self.cfg.decode_flash
        if not 1 <= qlen <= MAX_PRIME_Q or flash == "off":
            return False
        if flash == "on":
            return True
        if flash != "auto":
            raise ValueError(f"decode_flash={flash!r}")
        return kernels_take(k_cache)

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
        cache tensors are updated in place."""
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
        k_cache, v_cache = cache["k"], cache["v"]
        cursor = int(cache["cursor"])
        dev = k_cache.device
        h = self.embed_rl(tokens, position_id)
        mask, mask_s = self.ring_masks(qlen, cursor, dev)
        use_kernels = self.use_kernels(qlen, k_cache)
        idx = (None if qlen == 1 else
               (torch.arange(qlen, device=dev) + cursor) % M)
        for li, layer in enumerate(self.h):
            h, k_x, v_x = layer.forward_ring(
                h, rk_full[li], k_cache, v_cache, li, cursor, mask, mask_s,
                use_kernels)
            # write the q new rows at (cursor + t) % M: a q == 1 write never
            # wraps and is a slice assignment
            if qlen == 1:
                k_cache[li, :, cursor] = k_x[:, 0]
                v_cache[li, :, cursor] = v_x[:, 0]
            else:
                k_cache[li].index_copy_(1, idx, k_x)
                v_cache[li].index_copy_(1, idx, v_x)
        logits = self.logits(h[:, -1])
        return logits, {"k": k_cache, "v": v_cache,
                        "cursor": (cursor + qlen) % M}
