"""Greedy autoregressive action decoding over the ring K/V cache, the
classic path of bdm_db1_tpu/eval/decode.py.

One env step of a batch of envs: a prime forward over [obs || sep] (or
[prompt || obs || sep] at episode start, in <= 256-token ring slices; an
image prime in slices cut at transition boundaries, each with its
frames), then one single-token forward per action dim feeding back the
previous masked argmax with local-timestep id 0. With ``defer_last`` the last action token
is not fed: the caller carries it into the next step's prime as
``deferred_tok``, which saves one forward per step (exact under
same_length ring attention, where every query sees exactly mem_len keys
however the token stream is cut into forwards). The per-dim loop is a
Python loop whose tokens stay on the device; only the finished
``[B, action_length]`` block is read back, by the caller.

With ``pad_buckets`` (geometry buckets: ``"default"`` is
``DEFAULT_OBS_BUCKETS``) a one-slice prime, or the last slice of a chunked
prime, is padded up to the smallest bucket width that holds it with
query-only rows (token 0, position id 0) that the ring forward never
commits (``decode_rl_kv_ring(real_q=...)``), so envs whose observation
lengths differ share one positional projection per bucket width, and the
prime kernel sees a few fixed widths. The chains equal the unpadded ones.

With ``decode_weight_dtype`` "int8"/"int8a8", :func:`build_decoder_for_env`
(and so :class:`DecoderPool`) quantizes the model's trunk weights once, as
the JAX package's does. Speculative decode is not ported yet.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from bdm_db1_tpu_torch.core.vocab import VocabLayout
from bdm_db1_tpu_torch.data.packing import action_flags_and_position_ids
from bdm_db1_tpu_torch.eval.envs import is_discrete_space


class _LRU:
    """Tiny bounded cache for device-resident decode constants (position
    ids, logit biases, positional projections) keyed by geometry."""

    def __init__(self, cap: int):
        self.cap = cap
        self._d: OrderedDict = OrderedDict()

    def get(self, key, make):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        val = make()
        self._d[key] = val
        if len(self._d) > self.cap:
            self._d.popitem(last=False)
        return val


def fold_env_mask_bias(base_bias: np.ndarray, layout: VocabLayout,
                       discrete_action: bool, num_actions,
                       env_action_mask) -> np.ndarray:
    """Fold an env-supplied 0/1 action mask ([n] or [B, n]) into a base
    logit bias: banned discrete actions get -1e10."""
    if env_action_mask is None or not discrete_action:
        return base_bias
    m = np.asarray(env_action_mask, np.float32)
    extra = np.abs(m - 1) * 1e10
    lo = layout.discrete_offset
    hi = lo + num_actions
    if m.ndim == 1:
        bias = base_bias.copy()
        bias[lo:hi] -= extra
    else:
        bias = np.broadcast_to(
            base_bias, (m.shape[0],) + base_bias.shape).copy()
        bias[:, lo:hi] -= extra
    return bias


DEFAULT_OBS_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _bucket_for(width: int, buckets) -> Optional[int]:
    """Smallest bucket >= width (None: beyond the ladder, the prime keeps
    its exact width)."""
    for b in buckets:
        if b >= width:
            return b
    return None


def _prime_chunk(model_cfg) -> int:
    """Most tokens per ring prime slice (also bounds q <= mem_len)."""
    return min(256, model_cfg.mem_len)


class RkCache:
    """Positional projections per prime width, shared by the decoders of a
    :class:`DecoderPool` (a function of the model and the width only). The
    q == 1 projection, which every action token after the first takes, is
    held apart from the LRU of ``cap`` prime widths, so no mix of widths
    (the ten bucket widths, the 256-token slices, a chunked prime's last
    slice) ages it out."""

    def __init__(self, model, cap: int = 8):
        self.model = model
        self._lru = _LRU(cap)
        self._step = None

    def get(self, qlen: int) -> torch.Tensor:
        if qlen == 1:
            if self._step is None:
                self._step = self.model.precompute_rk(1)
            return self._step
        return self._lru.get(qlen, lambda: self.model.precompute_rk(qlen))

    def widths(self) -> List[int]:
        """The widths held, q == 1 first when it is."""
        return [1] * (self._step is not None) + list(self._lru._d)


class ActionDecoder:
    """Per-env-geometry greedy decoder over the model's ring cache."""

    def __init__(
        self,
        model,
        layout: VocabLayout,
        obs_length: int,
        action_length: int,
        discrete_action: bool,
        num_actions: Optional[int] = None,
        rk_cache: Optional[RkCache] = None,
        pad_buckets=None,
    ):
        cfg = model.cfg
        if not discrete_action and action_length > 1 and (
                cfg.decode_speculative or cfg.decode_spec_adaptive):
            raise NotImplementedError("speculative decode is not ported yet")
        if cfg.mem_len <= 0:
            raise NotImplementedError(
                "decode without a ring cache (mem_len 0) is not ported yet")
        self.model = model
        self.layout = layout
        self.obs_length = int(obs_length)
        self.action_length = int(action_length)
        self.discrete_action = discrete_action
        if discrete_action:
            assert num_actions is not None
            base = layout.discrete_action_logit_bias(num_actions)
        else:
            base = layout.continuous_action_logit_bias()
        self._base_bias = base
        self._num_actions = num_actions
        # deferring the last action token into the next prime is exact
        # only under same_length ring attention
        self.defers = bool(cfg.same_length)
        # geometry buckets: exact only where chunking is (same_length ring
        # attention), as in the JAX package
        if pad_buckets == "default":
            pad_buckets = DEFAULT_OBS_BUCKETS
        self.pad_buckets = (tuple(sorted(pad_buckets))
                            if pad_buckets and cfg.same_length else None)
        self._rk = rk_cache if rk_cache is not None else RkCache(model)
        self._bias_dev_cache = _LRU(8)
        self._pos_cache = _LRU(16)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def init_mems(self, batch_size: int = 1):
        return self.model.init_kv_cache_ring(batch_size)

    def decode(self, prime_tokens: np.ndarray, mems, prime_images=None,
               env_action_mask=None, deferred_tok=None,
               defer_last: bool = False) -> Tuple[np.ndarray, object]:
        """Greedy-decode one action per batch row; returns (action token ids
        [action_length] or [B, action_length] on the host, new mems)."""
        single = prime_tokens.ndim == 1
        act, new_mems = self.decode_async(
            prime_tokens, mems, prime_images, env_action_mask,
            deferred_tok=deferred_tok, defer_last=defer_last)
        act = act.cpu().numpy()
        return (act[0] if single else act), new_mems

    def chunk_plan(self, q: int, lead: int, n_frames: Optional[int] = None
                   ) -> Tuple[Optional[List[int]], Optional[Tuple[int, ...]]]:
        """The ring slices of a q-token prime whose first ``lead`` tokens
        are deferred action tokens, and with ``n_frames`` (an image prime)
        the frames of each slice: (sizes, frames), or (None, None) for a
        one-slice prime (chunking is exact only under same_length, and an
        image prime that :meth:`_image_chunk_plan` cannot cut goes whole).
        A lead token rides in the first slice, or in its own slice of no
        frames when that slice is full."""
        chunk = _prime_chunk(self.model.cfg)
        if q <= chunk or not self.model.cfg.same_length:
            return None, None
        qp = q - lead
        frames = None
        if n_frames is None:
            sizes = [chunk] * (qp // chunk)
            if qp % chunk:
                sizes.append(qp % chunk)
        else:
            plan = self._image_chunk_plan(qp, n_frames)
            if plan is None:
                return None, None
            sizes, frames = plan
        if lead:
            if sizes[0] + lead <= chunk:
                sizes[0] += lead
            else:
                sizes.insert(0, lead)
                if frames is not None:
                    frames = (0,) + tuple(frames)
        return sizes, frames

    def prime_plan(self, q: int, lead: int, n_frames: Optional[int] = None
                   ) -> Tuple[List[int], Optional[Tuple[int, ...]],
                              Optional[int]]:
        """The ring calls of a q-token prime as :meth:`chunk_plan` cuts it,
        with the geometry-bucket padding: (the widths of the calls, frames
        per call or None, the real rows of the last call or None when it is
        not padded). The one slice, or a chunked prime's last slice, of t
        tokens is padded to ``_bucket_for(t)`` when t < that width <=
        min(slice budget, mem_len); a one-slice prime longer than mem_len
        (the realigned prime) is not."""
        sizes, frames = self.chunk_plan(q, lead, n_frames)
        one = sizes is None
        widths = [q] if one else list(sizes)
        real_last = None
        M = self.model.cfg.mem_len
        if self.pad_buckets is not None and (not one or q <= M):
            t = widths[-1]
            w = _bucket_for(t, self.pad_buckets)
            if w is not None and t < w <= min(_prime_chunk(self.model.cfg),
                                              M):
                widths[-1], real_last = w, t
        return widths, frames, real_last

    def _image_chunk_plan(self, q: int, n_frames: int):
        """Transition-aligned slices of an image prime [T whole transitions
        || obs || sep] with one frame an observation: (slice sizes, frames
        per slice), or None when the prime does not decompose so (another
        frame count, a prime off the transition grid, or a transition
        longer than the slice budget). Every slice's -1 count is then
        whole frames, so each slice takes its own frames."""
        step = self.obs_length + self.action_length + 1
        tail = self.obs_length + 1
        chunk = _prime_chunk(self.model.cfg)
        if (q - tail) % step != 0 or step > chunk:
            return None
        n_trans = (q - tail) // step
        if n_frames != n_trans + 1:  # one frame per obs region, + reset obs
            return None
        t_per = chunk // step
        sizes, frames = [], []
        rem = n_trans
        while rem > 0:
            t = min(t_per, rem)
            sizes.append(t * step)
            frames.append(t)
            rem -= t
        if sizes and sizes[-1] + tail <= chunk:
            sizes[-1] += tail
            frames[-1] += 1
        else:
            sizes.append(tail)
            frames.append(1)
        return sizes, tuple(frames)

    @torch.no_grad()
    def decode_async(self, prime_tokens: np.ndarray, mems,
                     prime_images=None, env_action_mask=None,
                     deferred_tok: Optional[np.ndarray] = None,
                     defer_last: bool = False
                     ) -> Tuple[torch.Tensor, object]:
        """Like :meth:`decode` but returns the action tokens as a device
        tensor [B, action_length] without waiting for the device.

        ``defer_last=True`` (only when :attr:`defers`) skips the trailing
        cache-fold forward; the caller then feeds this call's last action
        token back as the next call's ``deferred_tok`` ([B] or [] int).
        ``prime_images`` ([T, H, W, C], or [B, T, H, W, C] with a batch of
        primes) are the frames of the prime's -1 slots, in order."""
        single = prime_tokens.ndim == 1
        if single:
            prime_tokens = prime_tokens[None]
            if prime_images is not None:
                prime_images = prime_images[None]
        defer_last = defer_last and self.defers
        lead = 0
        if deferred_tok is not None:
            assert self.defers, "deferred_tok needs same_length ring decode"
            dt = np.asarray(deferred_tok, np.int64)
            if single:
                dt = dt.reshape(1, -1)
            elif dt.ndim <= 1:          # one token per row
                dt = np.broadcast_to(
                    dt.reshape(-1), (prime_tokens.shape[0],))[:, None]
            prime_tokens = np.concatenate([dt, prime_tokens], axis=1)
            lead = dt.shape[1]
        b, q = prime_tokens.shape
        # long primes run through the ring in <= 256-token slices: the f32
        # [B, H, q, M+q] score buffers of a ~1000-token expert prompt are
        # what would not fit at large batch; a deferred lead token rides in
        # the first slice
        # the last (or only) slice may be padded to its bucket width with
        # query-only rows: token 0, position id 0
        sizes, frame_splits, real_last = self.prime_plan(
            q, lead, None if prime_images is None else prime_images.shape[1])
        pad_n = 0 if real_last is None else sizes[-1] - real_last
        if pad_n:
            prime_tokens = np.pad(prime_tokens, ((0, 0), (0, pad_n)))
        dev = self.device

        def _make_pos():
            _, p = action_flags_and_position_ids(
                q - lead, self.obs_length, self.action_length, 0)
            if lead:  # deferred action tokens carry the action slot id 0
                p = np.concatenate([np.zeros(lead, p.dtype), p])
            p = np.concatenate([p, np.zeros(pad_n, p.dtype)])
            return torch.as_tensor(
                np.broadcast_to(p[None], (b, q + pad_n)).copy(), device=dev)

        pos = self._pos_cache.get((b, q, lead, pad_n), _make_pos)
        bias = self._bias_dev_cache.get(b, lambda: torch.as_tensor(
            np.broadcast_to(self._base_bias,
                            (b,) + self._base_bias.shape).copy(),
            device=dev))
        if env_action_mask is not None and self.discrete_action:
            m = torch.as_tensor(np.asarray(env_action_mask, np.float32),
                                device=dev).expand(b, -1)
            lo = self.layout.discrete_offset
            bias = bias.clone()
            bias[:, lo:lo + m.shape[1]] -= (1.0 - m) * 1e10
        tokens = torch.as_tensor(prime_tokens, dtype=torch.int64, device=dev)
        images = (None if prime_images is None else torch.as_tensor(
            np.asarray(prime_images, np.float32), device=dev))
        rk_chunks = [self._rk.get(s) for s in sizes]
        return _decode_step(self.model, self.action_length, tokens, pos,
                            mems, bias, rk_chunks, self._rk.get(1),
                            defer_last, images, frame_splits, real_last)


def _decode_step(model, action_length: int, tokens: torch.Tensor,
                 pos: torch.Tensor, mems, bias: torch.Tensor,
                 rk_chunks, rk_step: torch.Tensor,
                 defer_last: bool = False, images=None, frame_splits=None,
                 real_last: Optional[int] = None):
    """Prime forward (one ring call per slice, slice ci taking
    ``frame_splits[ci]`` frames of ``images`` [B, T, H, W, C]) + the
    per-dim loop. tokens/pos [B, q]; bias [B, V]; returns ([B,
    action_length], mems). ``real_last`` is the real rows of the last
    slice when it is padded to its bucket width. A one-slice prime longer than mem_len (an image
    prime off the transition grid, or no same_length chunking) cannot
    scatter into the ring in one call: the ring is rotated to age order,
    the prime runs over the aligned cache (``decode_rl_kv``; an int8 cache
    dequantized first and its result quantized again) and the ring
    continues at cursor 0."""
    b, q = tokens.shape
    M = model.cfg.mem_len
    logits = None
    if len(rk_chunks) == 1 and q > M:
        logits, mems = _prime_aligned(model, tokens, pos, mems, rk_chunks[0],
                                      images)
    else:
        start = f0 = 0
        last = len(rk_chunks) - 1
        for ci, rk_c in enumerate(rk_chunks):
            size = rk_c.shape[1] - M
            img_c = images
            if images is not None and len(rk_chunks) > 1:
                nf = frame_splits[ci]
                img_c = images[:, f0:f0 + nf] if nf else None
                f0 += nf
            logits, mems = model.decode_rl_kv_ring(
                tokens[:, start:start + size], pos[:, start:start + size],
                mems, rk_c, img_c,
                real_q=real_last if ci == last else None)
            start += size
    tok = torch.argmax(logits + bias, dim=-1)
    acts = [tok]
    zero_pos = torch.zeros((b, 1), dtype=torch.int64, device=tokens.device)
    # with defer_last the final token is never fed; otherwise its feed only
    # folds it into the cache and its argmax is thrown away
    for _ in range(action_length - 1 if defer_last else action_length):
        lg, mems = model.decode_rl_kv_ring(tok[:, None], zero_pos, mems,
                                           rk_step)
        tok = torch.argmax(lg + bias, dim=-1)
        if len(acts) < action_length:
            acts.append(tok)
    return torch.stack(acts, dim=1), mems


def _prime_aligned(model, tokens, pos, mems, rk, images):
    """The one-slice prime longer than mem_len over the aligned cache:
    (logits, the new ring cache at cursor 0)."""
    from bdm_db1_tpu_torch.models.transformer_xl import (
        dequantize_kv, quantize_kv_rows,
    )

    quant = "k_scale" in mems
    ring = mems
    if quant:
        ring = {"k": dequantize_kv(mems["k"], mems["k_scale"], model.dtype),
                "v": dequantize_kv(mems["v"], mems["v_scale"], model.dtype),
                "cursor": mems["cursor"]}
    logits, aligned = model.decode_rl_kv(
        tokens, pos, model.align_ring_cache(ring), rk, images)
    if quant:
        (kq, ks), (vq, vs) = (quantize_kv_rows(aligned[k]) for k in "kv")
        aligned = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs,
                   "cursor": 0}
    return logits, aligned


class DecoderPool:
    """Shares decoders, and one positional-projection cache, across envs
    with the same decode geometry. With ``pad_buckets`` (``"default"`` or
    a ladder of widths) every decoder pads its primes to bucket widths, so
    envs of different observation lengths share one projection a bucket."""

    def __init__(self, model, pad_buckets=None):
        self.model = model
        self.rk_cache = RkCache(model)
        self.pad_buckets = pad_buckets
        self._cache = {}

    def get(self, tokenized_env) -> ActionDecoder:
        from bdm_db1_tpu_torch.eval.harness import decode_geometry

        key = decode_geometry(tokenized_env)
        if key not in self._cache:
            self._cache[key] = build_decoder_for_env(
                self.model, tokenized_env, rk_cache=self.rk_cache,
                pad_buckets=self.pad_buckets)
        return self._cache[key]


def _maybe_quantize_weights(model) -> None:
    """Opt-in int8 trunk weights for decode (ModelConfig.decode_weight_dtype
    "int8" or "int8a8", which share the quantized weights): quantize the
    loaded weights once, in place."""
    if model.cfg.decode_weight_dtype in ("int8", "int8a8"):
        model.quantize_decode_weights()


def build_decoder_for_env(model, tokenized_env, rk_cache=None,
                          pad_buckets=None) -> ActionDecoder:
    _maybe_quantize_weights(model)
    discrete = is_discrete_space(tokenized_env.action_space)
    return ActionDecoder(
        model,
        tokenized_env.tok.layout,
        obs_length=tokenized_env.obs_length,
        action_length=tokenized_env.action_length,
        discrete_action=discrete,
        num_actions=tokenized_env.action_space.n if discrete else None,
        rk_cache=rk_cache,
        pad_buckets=pad_buckets,
    )
