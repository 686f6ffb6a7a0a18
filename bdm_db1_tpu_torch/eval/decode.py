"""Greedy autoregressive action decoding over the ring K/V cache
(counterpart of bdm_db1_tpu/eval/decode.py).

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

Speculative (Jacobi) decode (``decode_speculative``, continuous actions of
more than one token): the whole previous action block is the deferred
lead of the next prime, and it is also the guess for this step's first
S = action_length - 1 tokens. The guesses ride the prime's last ring call
as a query-only tail (``spec_tail``), so that one forward gives candidates
for every action dim; verify forwards of the S guess rows, which commit
nothing, then repeat until each row's guesses equal its candidates. The
actions equal the sequential decode's (the same same_length argument).
``decode_spec_adaptive`` adds :class:`AdaptiveSpecSession`, which picks
the speculative or the classic path for each step from the verify rounds.

With ``decode_weight_dtype`` "int8"/"int8a8", :func:`build_decoder_for_env`
(and so :class:`DecoderPool`) quantizes the model's trunk weights once, as
the JAX package's does.

Pre-LN models decode over hidden-state memory [n_layer, B, mem_len, D]
(``use_kv_cache`` False, as in the JAX package): the prime is one
``decode_rl`` forward (no slices, buckets, deferral or speculation) and
each action dim another; every forward recomputes the K/V of the whole
memory in each layer. ``mem_len`` 0 is refused: the hidden memory would
grow with every forward there, and the JAX decoder fails on it; the
mem-less decode is :class:`WindowDecoder`.

:class:`WindowDecoder` is the stateless decode (no memory): a fixed padded
window of ``n_position`` tokens, one full forward through the trunk per
action dim.
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


def shard_decode_params(model, mesh):
    """This rank's tensor-parallel copy of ``model`` on ``mesh`` (a
    ``DeviceMesh`` named ("data", "model")): a ``TransformerXL`` holding
    its shard of the weights (the JAX ``shard_decode_params`` places the
    params by their logical axes). A model that is already sharded over
    that many ranks is returned as it is."""
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.parallel.mesh import tensor_parallel
    from bdm_db1_tpu_torch.train.convert import load_into

    tp = tensor_parallel(mesh)
    if model.tp is not None:
        if model.tp.size != tp.size:
            raise ValueError(f"the model is sharded over {model.tp.size} "
                             f"ranks, the mesh's model axis has {tp.size}")
        return model
    if model.decode_weights_quantized():
        raise ValueError("shard the model before quantize_decode_weights "
                         "(build_decoder_for_env does so)")
    out = TransformerXL(model.cfg, model.vocab, vision=model.vision,
                        device=model.device, tp=tp)
    load_into(out, model.state_dict())
    return out


class ActionDecoder:
    """Per-env-geometry greedy decoder over the model's ring cache (a
    pre-LN model: over its hidden-state memory). With ``mesh`` the decoder
    runs on this rank's tensor-parallel shard of the model
    (:func:`shard_decode_params`): its ring cache holds the rank's heads
    ([L, B, M, H / tp, Dh], allocated so), the kernels run on them, and the
    vocab-sharded logits are gathered before the action bias, so every
    rank of a model group takes the same greedy chain. The port's "data"
    axis is the env shard of the harness (``shard_envs`` over the data
    ranks), not a split of a decode call's rows."""

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
        mesh=None,
    ):
        if mesh is not None:
            model = shard_decode_params(model, mesh)
        self.mesh = mesh
        cfg = model.cfg
        if cfg.mem_len <= 0:
            raise ValueError(
                "ActionDecoder needs mem_len > 0: at mem_len 0 the trunk "
                "keeps the whole [memory || input] as the next memory, so "
                "the hidden memory grows by q rows a forward (the JAX "
                "decoder's action scan fails on that carry); decode without "
                "memory through the stateless window path (WindowDecoder, "
                "run_episode_stateless)")
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
        # the ring K/V cache serves post-LN models; pre-LN ones decode over
        # hidden-state memory (decode_rl)
        self.use_kv_cache = not cfg.pre_lnorm and cfg.mem_len > 0
        # deferring the last action token into the next prime is exact
        # only under same_length ring attention
        self.defers = self.use_kv_cache and bool(cfg.same_length)
        # speculative (Jacobi) decode: every action token defers into the
        # next prime, and the previous step's block is this step's guess
        self.speculates = ((cfg.decode_speculative or cfg.decode_spec_adaptive)
                           and self.defers and not discrete_action
                           and self.action_length > 1)
        # adaptive: an AdaptiveSpecSession picks the path per call; a bare
        # decode() still speculates every step
        self.spec_adaptive = self.speculates and cfg.decode_spec_adaptive
        # the trailing action tokens of a decode the caller carries into the
        # next call's deferred_tok
        self.defer_width = self.action_length if self.speculates else 1
        # cold-start guess: the mid-range continuous bin (~action 0.0); a
        # wrong guess costs verify rounds, never correctness
        self._default_guess = int(layout.continuous_offset
                                  + layout.num_continuous_bin // 2)
        self.last_spec_rounds = None
        # set by the first AdaptiveSpecSession.prewarm on this decoder
        self.spec_prewarmed = False
        # geometry buckets: exact only where chunking is (same_length ring
        # attention), as in the JAX package
        if pad_buckets == "default":
            pad_buckets = DEFAULT_OBS_BUCKETS
        self.pad_buckets = (tuple(sorted(pad_buckets)) if pad_buckets
                            and self.use_kv_cache and cfg.same_length
                            else None)
        self._rk = rk_cache if rk_cache is not None else RkCache(model)
        self._bias_dev_cache = _LRU(8)
        self._pos_cache = _LRU(16)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def init_mems(self, batch_size: int = 1):
        """The zero ring cache, or without it the zero hidden memory."""
        if self.use_kv_cache:
            return self.model.init_kv_cache_ring(batch_size)
        return self.model.init_mems(batch_size)

    def decode(self, prime_tokens: np.ndarray, mems, prime_images=None,
               env_action_mask=None, deferred_tok=None,
               defer_last: bool = False, speculate: Optional[bool] = None,
               guess_tok=None) -> Tuple[np.ndarray, object]:
        """Greedy-decode one action per batch row; returns (action token ids
        [action_length] or [B, action_length] on the host, new mems)."""
        single = prime_tokens.ndim == 1
        act, new_mems = self.decode_async(
            prime_tokens, mems, prime_images, env_action_mask,
            deferred_tok=deferred_tok, defer_last=defer_last,
            speculate=speculate, guess_tok=guess_tok)
        act = act.cpu().numpy()
        return (act[0] if single else act), new_mems

    def chunk_plan(self, q: int, lead: int, n_frames: Optional[int] = None
                   ) -> Tuple[Optional[List[int]], Optional[Tuple[int, ...]]]:
        """The ring slices of a q-token prime whose first ``lead`` tokens
        are deferred action tokens, and with ``n_frames`` (an image prime)
        the frames of each slice: (sizes, frames), or (None, None) for a
        one-slice prime (chunking is exact only under same_length, and an
        image prime that :meth:`_image_chunk_plan` cannot cut goes whole,
        and so does every prime over hidden-state memory). A lead token
        rides in the first slice, or in its own slice of no frames when
        that slice is full."""
        chunk = _prime_chunk(self.model.cfg)
        if (q <= chunk or not self.model.cfg.same_length
                or not self.use_kv_cache):
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

    def prime_plan(self, q: int, lead: int, n_frames: Optional[int] = None,
                   speculate: bool = False
                   ) -> Tuple[List[int], Optional[Tuple[int, ...]],
                              Optional[int]]:
        """The ring calls of a q-token prime as :meth:`chunk_plan` cuts it,
        with the geometry-bucket padding: (the widths of the calls, frames
        per call or None, the real rows of the last call or None when it is
        not padded). The one slice, or a chunked prime's last slice, of t
        tokens is padded to ``_bucket_for(t)`` when t < that width <=
        min(slice budget, mem_len), and on the speculative path (where the
        S guesses ride the padded call) <= mem_len - S; a one-slice prime
        longer than mem_len (the realigned prime) is not."""
        sizes, frames = self.chunk_plan(q, lead, n_frames)
        one = sizes is None
        widths = [q] if one else list(sizes)
        real_last = None
        M = self.model.cfg.mem_len
        if self.pad_buckets is not None and (not one or q <= M):
            t = widths[-1]
            w = _bucket_for(t, self.pad_buckets)
            room = self.action_length - 1 if speculate else 0
            if w is not None and t < w <= min(_prime_chunk(self.model.cfg),
                                              M - room):
                widths[-1], real_last = w, t
        return widths, frames, real_last

    def spec_plan(self, widths: List[int], frames, real_last: Optional[int],
                  images: bool = False
                  ) -> Tuple[List[int], Optional[Tuple[int, ...]], bool]:
        """The speculative path's ring calls for :meth:`prime_plan`'s
        (widths, frames, real_last): (widths, frames, tail), ``tail`` when
        the S guesses ride the last call (its width + S then). A last call
        that cannot take them (width + S > mem_len) is cut in two when it
        carries no frames; otherwise, as for the realigned prime, the prime
        commits plain and the first verify round finds the candidates.
        ``images``: the prime carries frames."""
        S = self.action_length - 1
        M = self.model.cfg.mem_len
        widths = list(widths)
        if widths[-1] > M:                  # the realigned one-slice prime
            return widths, frames, False
        if widths[-1] + S <= M:
            return widths, frames, True
        # a padded call's bucket cap is M - S, so it always fits
        assert real_last is None, (widths, S, M)
        if not images and M - S >= 1:
            t = widths[-1]
            widths[-1:] = [t - (M - S), M - S]
            return widths, frames, True
        return widths, frames, False

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
                     defer_last: bool = False,
                     speculate: Optional[bool] = None,
                     guess_tok: Optional[np.ndarray] = None
                     ) -> Tuple[torch.Tensor, object]:
        """Like :meth:`decode` but returns the action tokens as a device
        tensor [B, action_length] without waiting for the device (the
        speculative path reads one flag a verify round).

        ``defer_last=True`` (only when :attr:`defers`) skips the trailing
        cache-fold forward; the caller then feeds this call's last
        :attr:`defer_width` action tokens back as the next call's
        ``deferred_tok`` ([B, w], or [B] / [] for one token).
        ``prime_images`` ([T, H, W, C], or [B, T, H, W, C] with a batch of
        primes) are the frames of the prime's -1 slots, in order.
        ``speculate`` picks the path of a speculative decoder for this call
        (None: speculative whenever :attr:`speculates`; False: the classic
        per-dim loop); ``guess_tok`` ([B, >= S]) gives the guesses
        explicitly, as after a classic step whose deferred lead is one
        token."""
        single = prime_tokens.ndim == 1
        if single:
            prime_tokens = prime_tokens[None]
            if prime_images is not None:
                prime_images = prime_images[None]
            if guess_tok is not None:
                guess_tok = np.asarray(guess_tok).reshape(1, -1)
        defer_last = defer_last and self.defers
        lead = 0
        deferred = None
        if deferred_tok is not None:
            assert self.defers, "deferred_tok needs same_length ring decode"
            dt = np.asarray(deferred_tok, np.int64)
            if single:
                dt = dt.reshape(1, -1)
            elif dt.ndim <= 1:          # one token per row
                dt = np.broadcast_to(
                    dt.reshape(-1), (prime_tokens.shape[0],))[:, None]
            deferred = dt
            prime_tokens = np.concatenate([dt, prime_tokens], axis=1)
            lead = dt.shape[1]
        b, q = prime_tokens.shape
        spec = self.speculates if speculate is None \
            else (bool(speculate) and self.speculates)
        # long primes run through the ring in <= 256-token slices: the f32
        # [B, H, q, M+q] score buffers of a ~1000-token expert prompt are
        # what would not fit at large batch; a deferred lead rides in the
        # first slice. The last (or only) slice may be padded to its bucket
        # width with query-only rows: token 0, position id 0
        sizes, frame_splits, real_last = self.prime_plan(
            q, lead, None if prime_images is None else prime_images.shape[1],
            speculate=spec)
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
        if spec:
            return self._dispatch_spec(tokens, pos, mems, bias, images, sizes,
                                       frame_splits, deferred, defer_last,
                                       guess_tok, real_last)
        if not self.use_kv_cache:
            return _decode_step(self.model, self.action_length, tokens, pos,
                                mems, bias, None, None, images=images)
        rk_chunks = [self._rk.get(s) for s in sizes]
        return _decode_step(self.model, self.action_length, tokens, pos,
                            mems, bias, rk_chunks, self._rk.get(1),
                            defer_last, images, frame_splits, real_last)

    def _dispatch_spec(self, tokens, pos, mems, bias, images, sizes,
                       frame_splits, deferred, defer_last, guess_tok=None,
                       real_last=None) -> Tuple[torch.Tensor, object]:
        """The speculative call: the guesses (``guess_tok``, else a deferred
        lead of the whole previous action, else the mid-range cold guess),
        the ring calls with the guess tail on the last one
        (:meth:`spec_plan`) and their positional projections. Sets
        :attr:`last_spec_rounds`."""
        A = self.action_length
        S = A - 1
        b = tokens.shape[0]
        if guess_tok is not None:
            guesses = np.asarray(guess_tok, np.int64)[:, :S]
        elif deferred is not None and deferred.shape[1] == A:
            guesses = deferred[:, :S]
        else:
            guesses = np.full((b, S), self._default_guess, np.int64)
        sizes, frame_splits, tail = self.spec_plan(
            sizes, frame_splits, real_last, images is not None)
        assert tail or real_last is None
        rk_chunks = [self._rk.get(s + (S if tail and i == len(sizes) - 1
                                       else 0))
                     for i, s in enumerate(sizes)]
        act, mems, rounds = _decode_step_spec(
            self.model, A, tokens, pos, mems, bias, sizes, rk_chunks,
            self._rk.get(S), None if defer_last else self._rk.get(A),
            torch.as_tensor(np.ascontiguousarray(guesses), device=self.device),
            tail, images, frame_splits, real_last)
        # verify rounds of the last call: rounds + 1 forwards against the
        # action_length of the classic loop
        self.last_spec_rounds = rounds
        return act, mems


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
    continues at cursor 0.

    ``rk_chunks`` None is the hidden-state path (pre-LN models): mems is
    the hidden memory, the prime one ``decode_rl`` forward with all of
    ``images`` and each action dim another."""
    b, q = tokens.shape
    M = model.cfg.mem_len
    logits = None
    if rk_chunks is None:
        logits, mems = model.decode_rl(tokens, pos, mems, images)
    elif len(rk_chunks) == 1 and q > M:
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
        if rk_chunks is None:
            lg, mems = model.decode_rl(tok[:, None], zero_pos, mems)
        else:
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


def _leading_matches(ok: torch.Tensor) -> torch.Tensor:
    """Per-row length of the leading all-True run of ok [B, S]."""
    return torch.cumprod(ok.long(), dim=1).sum(dim=1)


def _decode_step_spec(model, action_length: int, tokens: torch.Tensor,
                      pos: torch.Tensor, mems, bias: torch.Tensor,
                      sizes: List[int], rk_chunks, rk_verify: torch.Tensor,
                      rk_fold: Optional[torch.Tensor], guesses: torch.Tensor,
                      tail: bool, images=None, frame_splits=None,
                      real_last: Optional[int] = None):
    """Speculative (Jacobi) greedy decode of one env step.

    tokens [B, q]: the commit block ([deferred previous action ||] obs ||
    sep), cut into ring calls of ``sizes`` (slice ci taking
    ``frame_splits[ci]`` frames, or all of ``images`` when there is one
    call); guesses [B, S = action_length - 1]. The prime commits as in
    :func:`_decode_step`; with ``tail`` its last call also carries the
    guesses as query-only rows (right after the real rows when the call is
    padded to a bucket: [real || guesses || pads]), so that one forward
    gives a candidate for every action dim: candidate j is exact whenever
    guesses 0..j-1 are. Verify forwards of the S candidate rows (q = S,
    nothing committed) then run until every row's guesses equal its
    candidates; candidate 0 is always exact, so each round confirms at
    least one more dim: at most S rounds, 0 at full acceptance. Without
    ``tail`` (a realigned prime, or a last call too wide for the
    guesses) at least one round runs, and at most S + 1. The loop reads
    one flag a round from the device, where the JAX package keeps the
    loop on the device; the actions and the round count are the same. A
    loop that passes S + 1 rounds raises: only a verify forward that is
    not deterministic gets there.

    With ``rk_fold`` (not deferring) a last forward commits the action
    block; otherwise the caller carries it into the next prime. Returns
    ([B, action_length], mems, rounds)."""
    b, q = tokens.shape
    S = action_length - 1
    M = model.cfg.mem_len
    gpos = torch.zeros((b, S), dtype=torch.int64, device=tokens.device)
    bias3 = bias[:, None, :]
    if len(sizes) == 1 and q > M:
        logits, mems = _prime_aligned(model, tokens, pos, mems, rk_chunks[0],
                                      images)
    else:
        start = f0 = 0
        last = len(sizes) - 1
        for ci, (size, rk_c) in enumerate(zip(sizes, rk_chunks)):
            st = S if tail and ci == last else 0
            tok_c = tokens[:, start:start + size]
            pos_c = pos[:, start:start + size]
            img_c = images
            if images is not None and len(sizes) > 1:
                nf = frame_splits[ci]
                img_c = images[:, f0:f0 + nf] if nf else None
                f0 += nf
            if st:
                r = size if real_last is None else real_last
                tok_c = torch.cat([tok_c[:, :r], guesses, tok_c[:, r:]], 1)
                pos_c = torch.cat([pos_c[:, :r], gpos, pos_c[:, r:]], 1)
            logits, mems = model.decode_rl_kv_ring(
                tok_c, pos_c, mems, rk_c, img_c, spec_tail=st,
                real_q=real_last if st else None)
            start += size
    if tail:
        # [B, S + 1] candidates; the leading guess matches are exact
        cand = torch.argmax(logits + bias3, dim=-1)
        done = _leading_matches(guesses == cand[:, :S]) >= S
        g = cand[:, :S]
    else:
        # dims past 0 are unverified placeholders: at least one round
        cand = torch.cat([torch.argmax(logits + bias, dim=-1)[:, None],
                          guesses], dim=1)
        done = torch.zeros(b, dtype=torch.bool, device=tokens.device)
        g = guesses
    rounds = 0
    while not bool(done.all()):
        if rounds > S:
            raise RuntimeError(
                f"speculative verify did not settle in {rounds} rounds "
                f"(S = {S}); rows done: {done.tolist()}")
        lg, _ = model.decode_rl_kv_ring(g, gpos, mems, rk_verify,
                                        spec_tail=S)
        # verify row j's logits give action dim j + 1; dim 0 is exact
        # from the prime
        cand = torch.cat([cand[:, :1], torch.argmax(lg + bias3, dim=-1)],
                         dim=1)
        done = done | (_leading_matches(g == cand[:, :S]) >= S)
        g = cand[:, :S]
        rounds += 1
    if rk_fold is not None:
        _, mems = model.decode_rl_kv_ring(
            cand, torch.zeros_like(cand), mems, rk_fold)
    return cand, mems, rounds


class DecoderPool:
    """Shares decoders, and one positional-projection cache, across envs
    with the same decode geometry. With ``pad_buckets`` (``"default"`` or
    a ladder of widths) every decoder pads its primes to bucket widths, so
    envs of different observation lengths share one projection a bucket.
    With ``mesh`` the model is sharded once (:func:`shard_decode_params`)
    and every decoder gets the shard. With ``track_spec_sessions`` every
    :class:`AdaptiveSpecSession` made on this pool's decoders appends
    itself to ``spec_sessions``, in creation order, so a driver can read
    their controllers across cohorts; off (``spec_sessions`` None) by
    default, since a long-lived server would keep one record an
    episode."""

    def __init__(self, model, pad_buckets=None, mesh=None,
                 track_spec_sessions: bool = False):
        if mesh is not None:
            model = shard_decode_params(model, mesh)
        self.model = model
        self.mesh = mesh
        self.rk_cache = RkCache(model)
        self.pad_buckets = pad_buckets
        self.spec_sessions = [] if track_spec_sessions else None
        self._cache = {}

    def get(self, tokenized_env) -> ActionDecoder:
        from bdm_db1_tpu_torch.eval.harness import decode_geometry

        key = decode_geometry(tokenized_env)
        if key not in self._cache:
            self._cache[key] = build_decoder_for_env(
                self.model, tokenized_env, rk_cache=self.rk_cache,
                pad_buckets=self.pad_buckets, mesh=self.mesh)
            if self.spec_sessions is not None:
                self._cache[key].spec_sessions = self.spec_sessions
        return self._cache[key]


class SpecController:
    """Host-side policy of adaptive speculation: speculate while the
    exponential average of the verify rounds stays at or below
    ``exit_rounds``, fall back to the classic per-dim loop above it (after
    ``min_obs`` observations, so one cold-start miss does not exit), and
    probe every ``probe_every`` classic steps, re-entering when a probe's
    rounds are at most ``reenter_rounds``. The constants are the JAX
    package's, so both take the same decisions on the same rounds; where
    speculation breaks even on the H100 is what chip_smoke.py's
    ``serve_spec`` phase measures."""

    def __init__(self, *, exit_rounds: float = 3.0,
                 reenter_rounds: float = 2.5, probe_every: int = 64,
                 alpha: float = 0.25, min_obs: int = 4):
        self.exit_rounds = float(exit_rounds)
        self.reenter_rounds = float(reenter_rounds)
        self.probe_every = int(probe_every)
        self.alpha = float(alpha)
        self.min_obs = int(min_obs)
        self.spec_mode = True
        self.ewma: Optional[float] = None
        self.n_obs = 0
        self.switches = 0          # diagnostics: mode flips so far
        self.spec_steps = 0        # diagnostics: steps run speculatively
        self.total_steps = 0
        self.rounds_sum = 0.0      # diagnostics: over observed spec steps
        self.rounds_n = 0
        self._since_probe = 0
        self._probing = False

    def decide(self) -> bool:
        """Call once per decode step, before dispatch: True to speculate."""
        self.total_steps += 1
        if self.spec_mode:
            self._probing = False
            self.spec_steps += 1
            return True
        self._since_probe += 1
        if self._since_probe >= self.probe_every:
            self._since_probe = 0
            self._probing = True
            self.spec_steps += 1
            return True
        self._probing = False
        return False

    def observe(self, rounds: float) -> None:
        """Feed the verify rounds of a speculative step."""
        r = float(rounds)
        self.rounds_sum += r
        self.rounds_n += 1
        if self._probing:
            # a probe's one sample decides re-entry; the average restarts
            # from it, so a stale bad average cannot veto
            if r <= self.reenter_rounds:
                self.spec_mode = True
                self.switches += 1
                self.ewma, self.n_obs = r, 1
            return
        self.ewma = r if self.ewma is None \
            else (1 - self.alpha) * self.ewma + self.alpha * r
        self.n_obs += 1
        if (self.spec_mode and self.n_obs >= self.min_obs
                and self.ewma > self.exit_rounds):
            self.spec_mode = False
            self.switches += 1
            self._since_probe = 0


class AdaptiveSpecSession:
    """Adaptive speculation for one decode chain (an episode or a lockstep
    cohort). The :class:`ActionDecoder` is shared by geometry, so the mode,
    the rounds average and the previous action block (the next guesses)
    live here. The caller keeps the deferred carry: :attr:`defer_width` is
    how many trailing action tokens the last call left uncommitted
    (action_length after a speculative step, 1 after a classic one). Both
    paths give the greedy actions, so a switch changes only the cost. The
    default controller exits at 0.6 S verify rounds and re-enters at 0.5 S
    (S = action_length - 1), as the JAX package's does."""

    def __init__(self, decoder: ActionDecoder,
                 controller: Optional[SpecController] = None):
        assert decoder.speculates, \
            "adaptive speculation needs a speculative-capable decoder"
        self.decoder = decoder
        if controller is None:
            S = decoder.action_length - 1
            controller = SpecController(exit_rounds=0.6 * S,
                                        reenter_rounds=0.5 * S)
        self.ctl = controller
        self.last_was_spec = True
        self.defer_width = decoder.action_length
        self._guess = None           # previous action block [B, A] (host)
        self._rounds = None          # rounds of the unharvested spec step
        reg = getattr(decoder, "spec_sessions", None)
        if reg is not None:          # a DecoderPool's opt-in registry
            reg.append(self)

    def decode_async(self, prime_tokens, mems, **kw):
        spec = self.ctl.decide()
        act, mems = self.decoder.decode_async(
            prime_tokens, mems, speculate=spec, guess_tok=self._guess, **kw)
        self.last_was_spec = spec
        self.defer_width = self.decoder.action_length if spec else 1
        self._rounds = self.decoder.last_spec_rounds if spec else None
        return act, mems

    def harvest(self, pending: torch.Tensor) -> np.ndarray:
        """The action tokens [B, A] of a pending decode on the host; feeds
        the step's verify rounds (already on the host) to the controller
        and keeps the block as the next guesses."""
        act = pending.cpu().numpy()
        if self._rounds is not None:
            self.ctl.observe(self._rounds)
            self._rounds = None
        self._guess = act
        return act

    def decode(self, prime_tokens, mems, **kw):
        act, mems = self.decode_async(prime_tokens, mems, **kw)
        act = self.harvest(act)
        return (act[0] if prime_tokens.ndim == 1 else act), mems

    def prewarm(self, prime_tokens, prime_images=None,
                env_action_mask=None) -> None:
        """Run every decode this session can dispatch at the given steady
        prime geometry, both modes at every deferred lead width a switch
        can leave (1 after a classic step, action_length after a
        speculative one), once against a scratch cache, which is then
        freed. Nothing compiles in the port; this builds the positional
        projections (``RkCache`` widths) that a mode switch would otherwise
        build in the middle of an episode. Runs once a decoder (the
        decoder's ``spec_prewarmed``); the controller and the guesses are
        untouched."""
        if self.decoder.spec_prewarmed:
            return
        p = np.asarray(prime_tokens)
        if p.ndim == 1:
            p = p[None]
            if prime_images is not None:
                prime_images = np.asarray(prime_images)[None]
        B = p.shape[0]
        A = self.decoder.action_length
        guess = np.full((B, A), self.decoder._default_guess, np.int64)
        mems = self.decoder.init_mems(B)
        for spec in (True, False):
            for w in (1, A):
                act, mems = self.decoder.decode_async(
                    p, mems, prime_images=prime_images,
                    env_action_mask=env_action_mask,
                    deferred_tok=guess[:, :w], defer_last=True,
                    speculate=spec, guess_tok=guess)
                act.cpu()
        del mems
        self.decoder.spec_prewarmed = True


def _maybe_quantize_weights(model) -> None:
    """Opt-in int8 trunk weights for decode (ModelConfig.decode_weight_dtype
    "int8" or "int8a8", which share the quantized weights): quantize the
    loaded weights once, in place."""
    if model.cfg.decode_weight_dtype in ("int8", "int8a8"):
        model.quantize_decode_weights()


def build_decoder_for_env(model, tokenized_env, rk_cache=None,
                          pad_buckets=None, mesh=None) -> ActionDecoder:
    """The env's decoder, on this rank's shard of ``model`` with ``mesh``
    (sharded before the int8 weights are made)."""
    if mesh is not None:
        model = shard_decode_params(model, mesh)
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
        mesh=mesh,
    )


class WindowDecoder:
    """Stateless (no-memory) decoder over a fixed padded token window of
    ``n_position`` tokens: the host keeps the sequence; each action dim is
    one full forward of the padded window through the trunk (causal
    attention makes the pad positions inert), the logits are read at each
    row's live position, and the argmax token is written back into the
    window on the device."""

    def __init__(self, model, layout: VocabLayout, obs_length: int,
                 action_length: int, discrete_action: bool,
                 num_actions: Optional[int] = None):
        self.model = model
        self.layout = layout
        self.obs_length = int(obs_length)
        self.action_length = int(action_length)
        self.discrete_action = discrete_action
        self.window = model.cfg.n_position
        if discrete_action:
            assert num_actions is not None
            self._base_bias = layout.discrete_action_logit_bias(num_actions)
        else:
            self._base_bias = layout.continuous_action_logit_bias()
        self._num_actions = num_actions

    def decode(self, seq_tokens: np.ndarray, env_action_mask=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """seq_tokens [q] (q + action_length <= window). Returns (action
        token ids [action_length], the sequence extended by them)."""
        acts, extended = self.decode_batch([seq_tokens], env_action_mask)
        return acts[0], extended[0]

    @torch.no_grad()
    def decode_batch(self, seqs, env_action_mask=None):
        """Rows of one geometry with their own live lengths: seqs a list of
        [q_i] token arrays (q_i + action_length <= window), env_action_mask
        None, [n] or [B, n]. Returns (action ids [B, action_length], the
        extended sequences)."""
        b = len(seqs)
        lengths = np.array([len(s) for s in seqs], np.int64)
        assert (lengths + self.action_length <= self.window).all(), (
            lengths, self.window)
        _, pos = action_flags_and_position_ids(
            self.window, self.obs_length, self.action_length, 0)
        padded = np.zeros((b, self.window), np.int64)
        for i, s in enumerate(seqs):
            padded[i, :lengths[i]] = s
        bias = fold_env_mask_bias(
            self._base_bias, self.layout, self.discrete_action,
            self._num_actions, env_action_mask)
        if bias.ndim == 1:
            bias = np.broadcast_to(bias, (b,) + bias.shape)
        dev = self.model.device
        acts = _window_decode(
            self.model, self.action_length,
            torch.as_tensor(padded, device=dev),
            torch.as_tensor(np.broadcast_to(pos, (b, self.window)).copy(),
                            device=dev),
            torch.as_tensor(lengths, device=dev),
            torch.as_tensor(np.array(bias, np.float32), device=dev))
        acts = acts.cpu().numpy()
        return acts, [np.concatenate([s, a]) for s, a in zip(seqs, acts)]


def _window_decode(model, action_length: int, tokens: torch.Tensor,
                   pos: torch.Tensor, lengths: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """One forward of the padded window [B, W] a dim: the logits at each
    row's position lengths + i - 1, the masked argmax written at lengths +
    i. A loop of action_length forwards with no host read inside it.
    Returns [B, action_length]."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    tokens = tokens.clone()
    acts = []
    for i in range(action_length):
        h, _ = model.trunk(model.embed_rl(tokens, pos), None)
        live = model.logits(h[rows, lengths + i - 1])          # [B, V]
        tok = torch.argmax(live + bias, dim=-1)
        tokens[rows, lengths + i] = tok
        acts.append(tok)
    return torch.stack(acts, dim=1)
