"""RL evaluation harness (counterpart of bdm_db1_tpu/eval/harness.py): the
one-episode loop (with memory, or stateless over a token window), per-env
evaluation, env sharding across processes and the lockstep batches.

``run_episode`` / ``evaluate_env`` run one env's episodes one at a time in
memory ("moving prompt") mode. In the lockstep path, B same-geometry envs
step together: one decode call per env step serves all B, the device holds
the ring caches, and the host tokenizes observations and steps the envs.
``dispatch`` enqueues a cohort's decode without waiting for the device;
``harvest_and_step`` reads the actions back and steps the envs, so an
interleaved loop overlaps one cohort's host work with another's device
work. With an adaptive speculative decoder each episode or cohort drives
its own ``AdaptiveSpecSession``. The models carry their weights, so no
entry takes a params tree.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from bdm_db1_tpu_torch.eval.decode import (
    ActionDecoder, AdaptiveSpecSession, DecoderPool, WindowDecoder,
    build_decoder_for_env,
)
from bdm_db1_tpu_torch.eval.envs import is_discrete_space
from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv


@dataclasses.dataclass
class EpisodeResult:
    env_name: str
    episode_return: float
    episode_length: int


def run_episode(
    env: TokenizedEnv,
    decoder: ActionDecoder,
    *,
    use_prompt: bool = True,
    strict_length: bool = True,
    minimal_expert_data: bool = False,
    max_step_size: Optional[int] = None,
    rng: Optional[np.random.RandomState] = None,
) -> EpisodeResult:
    """One episode in memory ("moving prompt") mode: the first prime is
    [prompt || obs || sep], every later one the new [obs || sep] (with the
    last action tokens in front when the decoder defers them), each with
    the frames of its -1 image slots. An adaptive speculative decoder runs
    the episode through its own ``AdaptiveSpecSession`` (the decoder's
    projections built once by ``prewarm`` at the steady geometry)."""
    sep = np.array([env.separator_id], dtype=np.int64)

    obs_tokens, obs_img, action_mask = env.reset()
    prime = np.concatenate([obs_tokens, sep])
    prime_img = obs_img
    if use_prompt:
        prompt, prompt_img = env.get_prompt(
            strict_length=strict_length,
            minimal_expert_data=minimal_expert_data, rng=rng)
        prime = np.concatenate([prompt, prime])
        prime_img = _cat_frames(prompt_img, obs_img)

    episode_return, episode_length = 0.0, 0
    done = False
    deferred = None
    sess = _spec_session(decoder, np.concatenate([obs_tokens, sep])[None],
                         None if obs_img is None else obs_img[None],
                         None if action_mask is None
                         else np.asarray(action_mask)[None])
    dec = sess.decode if sess is not None else decoder.decode
    mems = decoder.init_mems(1)

    while not done:
        act_tokens, mems = dec(
            prime, mems, prime_images=prime_img, env_action_mask=action_mask,
            deferred_tok=deferred, defer_last=decoder.defers)
        if decoder.defers:
            w = (sess.defer_width if sess is not None
                 else decoder.defer_width)
            deferred = act_tokens[-w:]
        action = env.tok.decode_action(act_tokens, env.discrete_action)
        obs_tokens, obs_img, action_mask, reward, done, _ = env.step(action)
        episode_return += reward
        episode_length += 1
        if max_step_size is not None and episode_length >= max_step_size:
            break
        # memory carries history; feed only the new observation
        prime = np.concatenate([obs_tokens, sep])
        prime_img = obs_img

    return EpisodeResult(env.ds.name, float(episode_return), episode_length)


def _spec_session(decoder: ActionDecoder, steady, steady_img, steady_mask
                  ) -> Optional[AdaptiveSpecSession]:
    """A new chain's ``AdaptiveSpecSession`` when the decoder is adaptive
    (None otherwise). The first session of a decoder runs ``prewarm`` at
    the steady [obs || sep] geometry before the chain's cache exists."""
    if not decoder.spec_adaptive:
        return None
    sess = AdaptiveSpecSession(decoder)
    sess.prewarm(steady, prime_images=steady_img,
                 env_action_mask=steady_mask)
    return sess


def evaluate_env(
    model,
    make_tokenized_env: Callable[[], TokenizedEnv],
    *,
    num_trials: int = 5,
    seed: int = 100,
    use_prompt: bool = True,
    strict_length: bool = True,
    minimal_expert_data: bool = False,
    max_step_size: Optional[int] = None,
    decoder_pool: Optional[DecoderPool] = None,
) -> Dict[str, float]:
    """Average return/length over ``num_trials`` episodes of one env, run
    one after another by :func:`run_episode`."""
    env = make_tokenized_env()
    env.seed(seed)
    rng = np.random.RandomState(seed)
    decoder = (decoder_pool.get(env) if decoder_pool is not None
               else build_decoder_for_env(model, env))
    rets, lens = [], []
    for _ in range(num_trials):
        res = run_episode(
            env, decoder, use_prompt=use_prompt, strict_length=strict_length,
            minimal_expert_data=minimal_expert_data,
            max_step_size=max_step_size, rng=rng)
        rets.append(res.episode_return)
        lens.append(res.episode_length)
    return {
        "env": env.ds.name,
        "return_mean": float(np.mean(rets)),
        "return_std": float(np.std(rets)),
        "length_mean": float(np.mean(lens)),
        "num_trials": num_trials,
    }


def run_episode_stateless(
    env: TokenizedEnv,
    decoder: WindowDecoder,
    *,
    use_prompt: bool = True,
    prompt_strategy: str = "fixed_prompt",
    strict_length: bool = True,
    minimal_expert_data: bool = False,
    max_step_size: Optional[int] = None,
    rng: Optional[np.random.RandomState] = None,
) -> EpisodeResult:
    """One episode without memory: the host keeps the token sequence and
    rolls it to fit the decoder's window, by whole transitions: with
    ``fixed_prompt`` the expert prompt stays and the oldest transition
    after it drops, otherwise the oldest transition drops."""
    sep = np.array([env.separator_id], dtype=np.int64)
    step_size = env.obs_length + env.action_length + 1
    window = decoder.window

    obs_tokens, _, action_mask = env.reset()
    if use_prompt:
        env.eval_prompt_strategy = prompt_strategy
        prompt, _ = env.get_prompt(
            strict_length=strict_length,
            minimal_expert_data=minimal_expert_data, rng=rng)
        prompt_len = len(prompt)
        seq = np.concatenate([prompt, obs_tokens, sep])
    else:
        prompt_len = 0
        seq = np.concatenate([obs_tokens, sep])

    def roll(seq: np.ndarray) -> np.ndarray:
        while len(seq) + env.action_length > window:
            if use_prompt and prompt_strategy == "fixed_prompt":
                seq = np.concatenate([seq[:prompt_len],
                                      seq[prompt_len + step_size:]])
            else:
                seq = seq[step_size:]
        return seq

    episode_return, episode_length = 0.0, 0
    done = False
    while not done:
        seq = roll(seq)
        act_tokens, seq = decoder.decode(seq, env_action_mask=action_mask)
        action = env.tok.decode_action(act_tokens, env.discrete_action)
        obs_tokens, _, action_mask, reward, done, _ = env.step(action)
        episode_return += reward
        episode_length += 1
        if max_step_size is not None and episode_length >= max_step_size:
            break
        seq = np.concatenate([seq, obs_tokens, sep])

    return EpisodeResult(env.ds.name, float(episode_return), episode_length)


def shard_envs(env_names: Sequence[str],
               process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> List[str]:
    """Round-robin env sharding across processes: rank and world size from
    ``torch.distributed`` when a process group is up, else 0 and 1."""
    up = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if up else 0
    if process_count is None:
        process_count = dist.get_world_size() if up else 1
    return [e for i, e in enumerate(env_names)
            if i % process_count == process_index]


def _cat_frames(*parts: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """The frames [T, H, W, C] of a prime's parts in order, or None."""
    parts = [p for p in parts if p is not None]
    return np.concatenate(parts, axis=0) if parts else None


@dataclasses.dataclass
class _SlotState:
    """Reset-time state of one lockstep slot (env already reset, expert
    prompt already sampled)."""
    prime: np.ndarray                # [prompt || obs || sep] token ids
    prime_img: Optional[np.ndarray]  # frames of every -1 slot in prime
    obs_img: Optional[np.ndarray]    # frames of the reset obs only
    mask: Optional[np.ndarray]       # env-supplied action mask


def _reset_env_state(env, *, use_prompt, strict_length,
                     minimal_expert_data, rng) -> _SlotState:
    sep = np.array([env.separator_id], dtype=np.int64)
    obs, img, mask = env.reset()
    if use_prompt:
        prompt, pimg = env.get_prompt(
            strict_length=strict_length,
            minimal_expert_data=minimal_expert_data, rng=rng)
        return _SlotState(np.concatenate([prompt, obs, sep]),
                          _cat_frames(pimg, img), img, mask)
    return _SlotState(np.concatenate([obs, sep]), img, img, mask)


def _cohort_key(st: _SlotState) -> Tuple:
    """What must agree for slots to share one device batch: the sampled
    prime shape, the frames' shape and the action-mask layout."""
    return (st.prime.shape,
            None if st.prime_img is None else st.prime_img.shape,
            None if st.mask is None else st.mask.shape)


class _LockstepCohort:
    """State of B same-geometry envs stepping in lockstep. A finished env is
    never stepped again; its slot replays its final observation so the
    batch keeps its shape, and its reward/length stop accumulating.
    ``pad_to`` replicates slot 0 (pre-finished, never stepped, dropped from
    the results) until the batch has that many slots."""

    def __init__(self, envs, decoder: ActionDecoder, *,
                 states: Optional[List[_SlotState]] = None,
                 use_prompt: bool = True, strict_length: bool = True,
                 minimal_expert_data: bool = False,
                 max_step_size: Optional[int] = None,
                 rng: Optional[np.random.RandomState] = None,
                 pad_to: Optional[int] = None):
        if states is None:
            rng = rng if rng is not None else np.random.RandomState(0)
            states = [
                _reset_env_state(
                    e, use_prompt=use_prompt, strict_length=strict_length,
                    minimal_expert_data=minimal_expert_data, rng=rng)
                for e in envs
            ]
        keys = {_cohort_key(s) for s in states}
        if len(keys) > 1:
            raise ValueError(
                "lockstep cohort is not homogeneous — prime/image/"
                "action-mask "
                f"shapes differ across slots: {sorted(map(str, keys))}. "
                "Group work items by sampled prime geometry "
                "(evaluate_envs_lockstep does) or use strict_length=True "
                "prompts so every sample has the same length.")
        self.n_real = len(envs)
        if pad_to is not None and pad_to > len(envs):
            n_pad = pad_to - len(envs)
            envs = list(envs) + [envs[0]] * n_pad
            states = list(states) + [states[0]] * n_pad
        self.envs = envs
        self.decoder = decoder
        self.max_step_size = max_step_size
        b = len(envs)
        self._sep = np.array([envs[0].separator_id], dtype=np.int64)
        self.prime = np.stack([s.prime for s in states])
        self.prime_img = (np.stack([s.prime_img for s in states])
                          if states[0].prime_img is not None else None)
        self.action_mask = (np.stack([s.mask for s in states])
                            if states[0].mask is not None else None)
        obs_sep = envs[0].obs_length + 1
        self.last_tokens = np.stack([s.prime[-obs_sep:] for s in states])
        self.last_imgs = (np.stack([s.obs_img for s in states])
                          if states[0].obs_img is not None else None)
        self.last_masks = (np.stack([s.mask for s in states])
                           if states[0].mask is not None else None)
        # adaptive speculation: the mode, rounds average and guesses are
        # the cohort's (the decoder is shared by geometry)
        self._sess = _spec_session(decoder, self.last_tokens, self.last_imgs,
                                   self.last_masks)
        self.mems = decoder.init_mems(b)
        self.returns = np.zeros(b)
        self.lengths = np.zeros(b, dtype=np.int64)
        self.done = np.zeros(b, dtype=bool)
        self.done[self.n_real:] = True  # padding slots never step
        self._pending = None
        # last-action deferral: every post-reset prime is [obs || sep] and
        # the previous step's last action tokens (the whole block on the
        # speculative path) ride in front of it
        self._defers = bool(decoder.defers)
        self._deferred = None

    def dispatch(self) -> None:
        dec = (self._sess.decode_async if self._sess is not None
               else self.decoder.decode_async)
        self._pending, self.mems = dec(
            self.prime, self.mems, prime_images=self.prime_img,
            env_action_mask=self.action_mask,
            deferred_tok=self._deferred, defer_last=self._defers)

    def harvest_and_step(self) -> bool:
        """Read back the pending actions, step live envs; True when all
        are done."""
        act_tokens = (self._sess.harvest(self._pending)
                      if self._sess is not None
                      else self._pending.cpu().numpy())
        self._pending = None
        if self._defers:
            w = (self._sess.defer_width if self._sess is not None
                 else self.decoder.defer_width)
            self._deferred = act_tokens if w > 1 else act_tokens[:, -1]
        live = np.flatnonzero(~self.done)
        if live.size == 0:
            return True
        env0 = self.envs[int(live[0])]
        actions = env0.tok.decode_action_batch(
            act_tokens, env0.discrete_action)
        raws, rewards, dones, masks = [], [], [], []
        for i in live:
            env = self.envs[i]
            a = int(actions[i]) if env.discrete_action else actions[i]
            raw, reward, d, _, mask = env.step_raw(a)
            raws.append(raw)
            rewards.append(reward)
            dones.append(d)
            masks.append(mask)
        self.returns[live] += np.asarray(rewards, np.float64)
        self.lengths[live] += 1
        done_now = np.asarray(dones, dtype=bool)
        if self.max_step_size is not None:
            done_now |= self.lengths[live] >= self.max_step_size
        self.done[live] = done_now
        # batch-tokenize the stepped observations, grouped by dataset
        tok_new = self.last_tokens.copy()
        img_new = self.last_imgs.copy() if self.last_imgs is not None else None
        mask_new = (self.last_masks.copy()
                    if self.last_masks is not None else None)
        groups: Dict[int, List[int]] = {}
        for j, i in enumerate(live):
            groups.setdefault(id(self.envs[i].ds), []).append(j)
        for idxs in groups.values():
            rows = live[idxs]
            obs_tok, img = self.envs[int(rows[0])].encode_obs_batch(
                [raws[j] for j in idxs])
            tok_new[rows, :-1] = obs_tok
            tok_new[rows, -1] = self._sep[0]
            if img_new is not None:
                img_new[rows] = img[:, None]
        if mask_new is not None:
            mask_new[live] = np.stack(masks)
        self.last_tokens, self.last_imgs = tok_new, img_new
        self.last_masks = mask_new
        if self.done.all():
            return True
        self.prime, self.prime_img = tok_new, img_new
        self.action_mask = mask_new
        return False

    def results(self) -> List[EpisodeResult]:
        return [EpisodeResult(self.envs[i].ds.name, float(self.returns[i]),
                              int(self.lengths[i]))
                for i in range(self.n_real)]  # padding slots dropped


def run_batched_episodes(
    envs: List[TokenizedEnv],
    decoder: ActionDecoder,
    *,
    use_prompt: bool = True,
    strict_length: bool = True,
    minimal_expert_data: bool = False,
    max_step_size: Optional[int] = None,
    rng: Optional[np.random.RandomState] = None,
) -> List[EpisodeResult]:
    """Run B same-geometry environments in lockstep, one decode call per
    env step for all of them."""
    cohort = _LockstepCohort(
        envs, decoder, use_prompt=use_prompt, strict_length=strict_length,
        minimal_expert_data=minimal_expert_data, max_step_size=max_step_size,
        rng=rng or np.random.RandomState(0))
    finished = False
    while not finished:
        cohort.dispatch()
        finished = cohort.harvest_and_step()
    return cohort.results()


def run_interleaved_episodes(
    env_groups: List[List[TokenizedEnv]],
    decoder: ActionDecoder,
    *,
    use_prompt: bool = True,
    strict_length: bool = True,
    minimal_expert_data: bool = False,
    max_step_size: Optional[int] = None,
    rng: Optional[np.random.RandomState] = None,
    states_groups: Optional[List[List[_SlotState]]] = None,
    pad_to: Optional[int] = None,
) -> List[List[EpisodeResult]]:
    """Run several same-geometry cohorts, each cohort's decode enqueued
    while the host steps the others. Returns one result list per group."""
    rng = rng or np.random.RandomState(0)
    cohorts = [
        _LockstepCohort(
            envs, decoder,
            states=states_groups[i] if states_groups is not None else None,
            use_prompt=use_prompt,
            strict_length=strict_length,
            minimal_expert_data=minimal_expert_data,
            max_step_size=max_step_size, rng=rng, pad_to=pad_to)
        for i, envs in enumerate(env_groups)
    ]
    live = list(cohorts)
    for c in live:
        c.dispatch()
    while live:
        nxt = []
        for c in live:
            if c.harvest_and_step():
                continue
            c.dispatch()
            nxt.append(c)
        live = nxt
    return [c.results() for c in cohorts]


def decode_geometry(tenv: TokenizedEnv) -> Tuple:
    """Decode-geometry key: envs with equal keys share a decoder and may
    run in the same lockstep batch."""
    discrete = is_discrete_space(tenv.action_space)
    return (tenv.obs_length, tenv.action_length, discrete,
            tenv.action_space.n if discrete else None)


def evaluate_envs_lockstep(
    model,
    env_names: Sequence[str],
    make_tokenized_env: Callable[[str], TokenizedEnv],
    *,
    num_trials: int = 5,
    seed: int = 100,
    batch_size: int = 16,
    decoder_pool: Optional[DecoderPool] = None,
    use_prompt: bool = True,
    strict_length: bool = True,
    minimal_expert_data: bool = False,
    max_step_size: Optional[int] = None,
    interleave: int = 2,
    pad_cohorts: bool = True,
) -> List[Dict[str, float]]:
    """Lockstep evaluation of ``num_trials`` episodes per env: bucket
    (env, trial) work items by decode geometry, reset envs and sample
    prompts a wave at a time, group each wave by the sampled prime
    geometry, fill batches of up to ``batch_size`` slots (padded to exactly
    ``batch_size`` with ``pad_cohorts``), and run ``interleave`` batches at a
    time through :func:`run_interleaved_episodes`. Returns one record per
    env: return mean/std, mean length and trial count. The model carries
    its weights and device."""
    pool = decoder_pool or DecoderPool(model)

    probes: Dict[str, List[TokenizedEnv]] = {}
    geom: Dict[str, Tuple] = {}
    for name in env_names:
        t = make_tokenized_env(name)
        probes[name] = [t]
        geom[name] = decode_geometry(t)

    buckets: Dict[Tuple, List[Tuple[str, int]]] = defaultdict(list)
    for name in env_names:
        for trial in range(num_trials):
            buckets[geom[name]].append((name, trial))

    episodes: Dict[str, List[EpisodeResult]] = defaultdict(list)
    interleave = max(1, interleave)
    prompt_rng = np.random.RandomState(seed)
    wave_size = interleave * batch_size
    for key in buckets:
        items = buckets[key]
        for wstart in range(0, len(items), wave_size):
            recs = []
            for name, trial in items[wstart:wstart + wave_size]:
                t = (probes[name].pop() if probes[name]
                     else make_tokenized_env(name))
                t.seed(seed + trial)
                st = _reset_env_state(
                    t, use_prompt=use_prompt, strict_length=strict_length,
                    minimal_expert_data=minimal_expert_data, rng=prompt_rng)
                recs.append((name, t, st))
            sub: Dict[Tuple, List] = defaultdict(list)
            for rec in recs:
                sub[_cohort_key(rec[2])].append(rec)
            chunks = [srecs[s:s + batch_size]
                      for srecs in sub.values()
                      for s in range(0, len(srecs), batch_size)]
            for gstart in range(0, len(chunks), interleave):
                group = chunks[gstart:gstart + interleave]
                env_groups = [[r[1] for r in c] for c in group]
                state_groups = [[r[2] for r in c] for c in group]
                decoder = pool.get(env_groups[0][0])
                group_results = run_interleaved_episodes(
                    env_groups, decoder,
                    states_groups=state_groups,
                    pad_to=batch_size if pad_cohorts else None,
                    max_step_size=max_step_size)
                for chunk, results in zip(group, group_results):
                    for (name, t, _), res in zip(chunk, results):
                        episodes[name].append(res)
                        probes[name].append(t)  # recycle: episode is over

    out = []
    for name in env_names:
        eps = episodes[name]
        out.append({
            "env": eps[0].env_name,
            "return_mean": float(np.mean([e.episode_return for e in eps])),
            "return_std": float(np.std([e.episode_return for e in eps])),
            "length_mean": float(np.mean([e.episode_length for e in eps])),
            "num_trials": len(eps),
        })
    return out


def parallel_evaluate_envs(
    model, env_names: Sequence[str],
    make_tokenized_env: Callable[[str], TokenizedEnv], **kwargs
) -> List[Dict[str, float]]:
    """:func:`evaluate_env` over this process's env shard
    (:func:`shard_envs`), one record per env, gathered across the
    processes of a ``torch.distributed`` world (:func:`gather_records`)."""
    pool = kwargs.pop("decoder_pool", None) or DecoderPool(model)
    return gather_records([
        evaluate_env(model, lambda n=name: make_tokenized_env(n),
                     decoder_pool=pool, **kwargs)
        for name in shard_envs(env_names)])


def gather_records(local: List[Dict], tp=None) -> List[Dict]:
    """Every process's records in rank-major order (rank 0's shard, then
    rank 1's, ...), on every process; ``local`` itself without a process
    group. The JAX package's ``process_allgather`` of the record dicts
    would gather each leaf instead, and cannot carry the env names. Under
    tensor parallelism (``tp``, parallel/mesh.py ``TensorParallel``) the
    ranks of a data rank's block (its model group, and on a mesh with a
    pipe axis the model groups of every stage) hold the same records: one
    copy a data rank, from the first rank of its block (world rank
    d * world / dp), in data-rank order."""
    if not (dist.is_available() and dist.is_initialized()):
        return local
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    if tp is not None:
        gathered = gathered[::len(gathered) // tp.data_size]
    return [r for rank in gathered for r in rank]
