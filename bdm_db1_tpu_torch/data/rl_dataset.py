"""RL trajectories, their tokenization and packed training samples (the
counterpart of bdm_db1_tpu/data/rl_dataset.py).

* ``TrajectoryStore`` — per-trajectory storage, built in memory from a
  d4rl-style flat dataset or attached lazily (mmap) to an on-disk cache in
  the reference's layout (``save_cache`` writes it: per-trajectory ``.npy``
  files per obs-tree leaf, action and reward, plus ``path_lengths.npy`` and
  ``traj_returns.npy``), so a cache written by either package is read by
  both.
* ``RLTokenizerSuite`` — per-obs-type tokenization with the unified vocab
  offsets.
* ``RLFullDataset`` — the dataset meta (obs/action token widths, transition
  budget), the sample index, packed samples (``get``, with prompt
  conditioning drawn from ``self.rng`` in the JAX package's order, so one
  seed gives the same samples in both), and expert-prompt sampling.
  With a ``cache_dir`` its meta and sample index are read from (or
  written to) ``<cache_dir>/<name>/meta``, the JAX package's files.
* ``RLDataset`` / ``split_rl_dataset`` — train/valid/test views;
  ``RLFinetuneDataset`` — the few-shot view (the first N trajectories).
* ``make_rl_creator`` — the dataset factory's "rl" and "rl_task_suite"
  creators (data/dataset_utils.py).
* ``build_rl_dataset_from_cache`` — the dataset of one env from its cache
  (built from the live env first when absent).

Image observations ([T, 3, H, W] leaves) take ``(H/p)(W/p)`` -1 token
slots a timestep (one image leaf an observation); a sample carries its
frames as ``images`` [transition_num, H, W, C], zero-padded, with the slots
of the padded transitions marked -1. A text observation leaf (strings)
takes its tokenized length in slots, first in the observation.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

from bdm_db1_tpu_torch.core.logging import process_index
from bdm_db1_tpu_torch.core.vocab import VocabLayout
from bdm_db1_tpu_torch.data import native
from bdm_db1_tpu_torch.data.blendable import BlendableDataset
from bdm_db1_tpu_torch.data.dataset_utils import get_train_valid_test_split_
from bdm_db1_tpu_torch.data.packing import (
    action_flags_and_position_ids, truncate_or_pad,
)
from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer

ObsTree = Union[np.ndarray, Dict[str, np.ndarray]]


# obs trees are flat arrays or one-level dicts; the map recurses through
# tuples too, because segment() maps over an (obs, act, rew) tuple
def tree_map(fn: Callable, tree: ObsTree, *rest):
    if isinstance(tree, dict):
        return {
            k: tree_map(fn, tree[k], *[r[k] for r in rest])
            for k in sorted(tree)
        }
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, x, *[r[i] for r in rest])
            for i, x in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_leaves(tree: ObsTree) -> List[Any]:
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


def tree_paths(tree: ObsTree) -> List[Tuple[str, ...]]:
    if isinstance(tree, dict):
        return [(k,) for k in sorted(tree)]
    return [()]


def qlearning_dataset_with_timeouts(dataset: Dict[str, np.ndarray]) -> Dict:
    """Normalize a d4rl-style dict: merge terminals|timeouts into done."""
    terminal = np.asarray(dataset["terminals"]).reshape(-1)
    done = terminal
    if "timeouts" in dataset:
        done = terminal | np.asarray(dataset["timeouts"]).reshape(-1)
    return {
        "observations": dataset["observations"],
        "actions": np.asarray(dataset["actions"]),
        "rewards": np.asarray(dataset["rewards"]).reshape(-1, 1),
        "terminals": done.reshape(-1, 1),
    }


def segment(traj_input, terminals: np.ndarray,
            max_path_length: Optional[int] = None) -> List:
    """Split flat arrays into per-trajectory chunks at terminal flags."""
    terminals = np.asarray(terminals).reshape(-1)
    n = len(terminals)
    trajectories = []
    start = 0
    for i in range(n):
        if terminals[i] or (
            max_path_length is not None and i - start + 1 >= max_path_length
        ):
            trajectories.append(tree_map(lambda x: x[start: i + 1], traj_input))
            start = i + 1
    if start < n:
        trajectories.append(tree_map(lambda x: x[start:n], traj_input))
    return trajectories


def obs_type_of(x: np.ndarray) -> str:
    if x.ndim == 4:
        assert x.shape[1] == 3, "rgb input should be (T, 3, h, w)"
        return "image"
    if "float" in x.dtype.name:
        return "float"
    if "str" in x.dtype.name:
        return "text"
    if "int" in x.dtype.name:
        return "discrete"
    raise ValueError(f"unsupported obs dtype {x.dtype}")


class RLTokenizerSuite:
    """Per-modality tokenization with unified vocab offsets."""

    def __init__(self, layout: VocabLayout, scalar: ScalarTokenizer,
                 text_tokenizer=None, vision_patch_size: int = 16):
        self.layout = layout
        self.scalar = scalar
        self.text_tokenizer = text_tokenizer
        self.vision_patch_size = vision_patch_size

    def obs_dim_of(self, x: np.ndarray, obs_type: str) -> int:
        """Token count contributed by one obs leaf per timestep (a text
        leaf: the tokenized length of its first string)."""
        if obs_type == "text":
            enc = self.text_tokenizer(list(x.reshape(-1)[:1]))["input_ids"]
            return max(len(t) for t in enc)
        if obs_type == "image":
            _, _, h, w = x.shape
            p = self.vision_patch_size
            return (h // p) * (w // p)
        return int(np.prod(x.shape[1:])) if x.ndim > 1 else 1

    def encode_obs_leaf(self, x: np.ndarray, obs_type: str, obs_dim: int):
        """-> (text_tokens, image, tensor_tokens), exactly one non-None.
        Text is padded or cut to ``obs_dim`` tokens a timestep."""
        if obs_type == "text":
            ids = self.text_tokenizer(
                [str(s) for s in x.reshape(-1)], padding="max_length",
                truncation=True, max_length=obs_dim,
            )["input_ids"]
            return np.asarray(ids, dtype=np.int64), None, None
        if obs_type == "image":
            return None, x, None
        if obs_type == "float":
            bins = self.scalar.discretize_np(x, is_action=False)
            tok = self.layout.encode_continuous(bins.astype(np.int64))
        else:  # discrete
            assert x.min() >= 0 and x.max() < self.layout.num_discrete_values
            tok = self.layout.encode_discrete(x.astype(np.int64))
        if tok.ndim < 2:
            tok = tok[:, None]
        return None, None, tok

    def encode_action(self, act: np.ndarray) -> np.ndarray:
        if "float" in act.dtype.name:
            bins = self.scalar.discretize_np(act, is_action=True)
            return self.layout.encode_continuous(bins.astype(np.int64))
        assert act.min() >= 0 and act.max() < self.layout.num_discrete_values
        if act.ndim == 1:
            act = act[:, None]
        return self.layout.encode_discrete(act.astype(np.int64))

    def decode_action(self, tokens: np.ndarray, discrete: bool):
        """Model tokens ``[action_length]`` -> one env action."""
        if discrete:
            return int(self.layout.decode_discrete(tokens)[0])
        bins = self.layout.decode_continuous(tokens)
        return self.scalar.decode_np(bins, is_action=True)

    def decode_action_batch(self, tokens: np.ndarray, discrete: bool):
        """Model tokens ``[B, action_length]`` -> env actions: ``[B]`` ints
        (discrete) or ``[B, action_length]`` floats."""
        tokens = np.asarray(tokens)
        if discrete:
            return self.layout.decode_discrete(tokens)[:, 0].astype(np.int64)
        bins = self.layout.decode_continuous(tokens)
        return self.scalar.decode_np(bins, is_action=True)


class TrajectoryStore:
    """Per-env trajectory storage with the reference cache layout."""

    def __init__(self, observations: Sequence[ObsTree],
                 actions: Sequence[np.ndarray],
                 rewards: Sequence[np.ndarray]):
        self.observations = list(observations)
        self.actions = list(actions)
        self.rewards = list(rewards)
        self.path_lengths = np.array([len(a) for a in self.actions])
        self.traj_returns = np.array(
            [float(np.sum(r)) for r in self.rewards], dtype=np.float32)
        self._lazy_dir: Optional[Path] = None
        self._obs_paths: Optional[List[Tuple[str, ...]]] = None

    @classmethod
    def from_flat_dataset(cls, dataset: Dict[str, np.ndarray],
                          max_path_length: Optional[int] = None):
        d = qlearning_dataset_with_timeouts(dataset)
        trajs = segment(
            (d["observations"], d["actions"], d["rewards"]),
            d["terminals"], max_path_length,
        )
        obs, act, rew = zip(*trajs)
        return cls(obs, act, rew)

    @classmethod
    def from_env_name(cls, env_name: str, cache_dir: str,
                      max_path_length: Optional[int] = None
                      ) -> "TrajectoryStore":
        """Attach to the env's cache, building it first from the live env
        when absent: process 0 resolves the env (``make_env``), takes its
        offline dataset (``get_dataset`` for d4rl envs, ``make_dataset``
        for the fakes), segments it and writes the cache; the other
        processes wait at a barrier when a process group is up."""
        root = Path(cache_dir) / env_name
        if not (root / "path_lengths.npy").exists():
            if process_index() == 0:
                from bdm_db1_tpu_torch.eval.envs import make_env

                env = make_env(env_name)
                if hasattr(env, "get_dataset"):      # d4rl API
                    flat = env.get_dataset()
                elif hasattr(env, "make_dataset"):   # scripted fakes
                    flat = env.make_dataset()
                else:
                    raise ValueError(
                        f"env {env_name!r} has no offline dataset "
                        "(get_dataset/make_dataset) and no cache at "
                        f"{root}")
                cls.from_flat_dataset(flat, max_path_length).save_cache(
                    cache_dir, env_name)
            if dist.is_available() and dist.is_initialized():
                dist.barrier()
        return cls.from_cache_dir(cache_dir, env_name)

    @classmethod
    def from_cache_dir(cls, cache_dir: str, env_name: str
                       ) -> "TrajectoryStore":
        """Attach lazily to a cache directory written by ``save_cache`` (or
        by the reference or the JAX package; the same layout)."""
        root = Path(cache_dir) / env_name
        store = cls.__new__(cls)
        store._lazy_dir = root
        store.path_lengths = np.load(root / "path_lengths.npy")
        store.traj_returns = np.load(root / "traj_returns.npy")
        store.observations = store.actions = store.rewards = None
        # the obs tree from the directory structure
        obs_root = root / "observations"
        subdirs = sorted(
            d.name for d in obs_root.iterdir() if d.is_dir()
        ) if obs_root.exists() else []
        store._obs_paths = [(s,) for s in subdirs] if subdirs else [()]
        return store

    @property
    def num_trajectories(self) -> int:
        return len(self.path_lengths)

    def get(self, path_idx: int, start: Optional[int] = None,
            end: Optional[int] = None) -> Tuple[ObsTree, np.ndarray]:
        """Slice one trajectory (mmap reads when cache-attached)."""
        start = start or 0
        if self._lazy_dir is not None:
            root = self._lazy_dir
            act = np.load(root / "actions" / f"{path_idx}.npy", mmap_mode="r")
            end = end if end is not None else len(act)
            if self._obs_paths == [()]:
                obs = np.load(
                    root / "observations" / f"{path_idx}.npy", mmap_mode="r"
                )[start:end]
            else:
                obs = {
                    p[0]: np.load(
                        root / "observations" / p[0] / f"{path_idx}.npy",
                        mmap_mode="r",
                    )[start:end]
                    for p in self._obs_paths
                }
            return obs, np.asarray(act[start:end])
        end = end if end is not None else len(self.actions[path_idx])
        obs = tree_map(lambda x: x[start:end], self.observations[path_idx])
        return obs, self.actions[path_idx][start:end]

    def save_cache(self, cache_dir: str, env_name: str) -> None:
        """Write the reference on-disk layout under
        ``<cache_dir>/<env_name>``."""
        root = Path(cache_dir) / env_name
        (root / "actions").mkdir(parents=True, exist_ok=True)
        (root / "rewards").mkdir(parents=True, exist_ok=True)
        for p in tree_paths(self.observations[0]):
            (root / "observations" / "/".join(p)).mkdir(
                parents=True, exist_ok=True)
        for i in range(self.num_trajectories):
            obs = self.observations[i]
            for p, leaf in zip(tree_paths(obs), tree_leaves(obs)):
                np.save(root / "observations" / "/".join(p) / f"{i}.npy", leaf)
            np.save(root / "actions" / f"{i}.npy", np.asarray(self.actions[i]))
            np.save(root / "rewards" / f"{i}.npy", np.asarray(self.rewards[i]))
        np.save(root / "path_lengths.npy", np.asarray(self.path_lengths))
        np.save(root / "traj_returns.npy", self.traj_returns)


class RLFullDataset:
    """Packed Gato samples over one environment's trajectories, with the
    tokenization and prompt sampling that evaluation reads."""

    def __init__(
        self,
        name: str,
        store: TrajectoryStore,
        tokenizer: RLTokenizerSuite,
        seq_length: int,
        *,
        use_prompt: bool = True,
        prompt_ratio: float = 0.5,
        prompt_prob: float = 0.25,
        prompt_at_final_transition_prob: float = 0.5,
        prompt_strategy: str = "stochastic_subseq",
        cache_dir: Optional[str] = None,
        seed: Optional[int] = None,
    ):
        self.name = name
        self.store = store
        self.tok = tokenizer
        self.output_sequence_length = int(seq_length)
        self.use_prompt = use_prompt
        self.prompt_ratio = prompt_ratio
        self.prompt_prob = prompt_prob
        self.prompt_at_final_transition_prob = prompt_at_final_transition_prob
        self.prompt_strategy = prompt_strategy
        self.rng = np.random.RandomState(seed)

        meta_dir = (
            Path(cache_dir) / name / "meta" if cache_dir is not None else None
        )
        if meta_dir is not None and (meta_dir / "action_dim.npy").exists():
            self._load_meta(meta_dir)
        else:
            self._build_meta()
            if meta_dir is not None:
                self._save_meta(meta_dir)

        # sample index: one sample per timestep of every trajectory
        index_path = (
            meta_dir / f"indices_{seq_length}.npy" if meta_dir is not None
            else None
        )
        if index_path is not None and index_path.exists():
            self.indices = np.load(index_path, mmap_mode="r")
        else:
            self.indices = native.build_rl_sample_idx(
                self.store.path_lengths, self.transition_num)
            if index_path is not None:
                index_path.parent.mkdir(parents=True, exist_ok=True)
                np.save(index_path, self.indices)
        # top-return trajectories first, for expert-prompt sampling
        self._ret_order = np.argsort(-self.store.traj_returns, kind="stable")

    def _build_meta(self) -> None:
        obs0, act0 = self.store.get(0)
        self.obs_type_spec = tree_map(obs_type_of, obs0)
        self.observation_dims_for_spec = tree_map(
            lambda x, t: self.tok.obs_dim_of(x, t), obs0, self.obs_type_spec)
        self.observation_dim = int(
            sum(tree_leaves(self.observation_dims_for_spec)))
        a0 = act0[0]
        self.action_dim = int(a0.shape[0]) if a0.ndim >= 1 else 1
        trans_dim = self.observation_dim + self.action_dim
        # whole transitions that fit seq_length + 1 tokens
        self.transition_num = (
            self.output_sequence_length + trans_dim) // (trans_dim + 1)
        self.prompt_transition_num = int(self.prompt_ratio * self.transition_num)
        self.predicted_transition_num = (
            self.transition_num - self.prompt_transition_num)

    def _save_meta(self, meta_dir: Path) -> None:
        meta_dir.mkdir(parents=True, exist_ok=True)
        np.save(meta_dir / "output_sequence_length.npy",
                np.array(self.output_sequence_length))
        np.save(meta_dir / "obs_type_spec.npy", np.array(self.obs_type_spec))
        np.save(meta_dir / "observation_dims_for_spec.npy",
                np.array(self.observation_dims_for_spec))
        np.save(meta_dir / "observation_dim.npy", np.array(self.observation_dim))
        np.save(meta_dir / "action_dim.npy", np.array(self.action_dim))
        np.save(meta_dir / "transition_sequence_length.npy",
                np.array(self.transition_num))

    def _load_meta(self, meta_dir: Path) -> None:
        def _load(name):
            return np.load(meta_dir / f"{name}.npy", allow_pickle=True)

        self.output_sequence_length = int(_load("output_sequence_length"))
        spec = _load("obs_type_spec")
        self.obs_type_spec = spec.item() if spec.shape == () else spec
        dims = _load("observation_dims_for_spec")
        self.observation_dims_for_spec = (
            dims.item() if dims.shape == () else dims)
        self.observation_dim = int(_load("observation_dim"))
        self.action_dim = int(_load("action_dim"))
        self.transition_num = int(_load("transition_sequence_length"))
        self.prompt_transition_num = int(self.prompt_ratio * self.transition_num)
        self.predicted_transition_num = (
            self.transition_num - self.prompt_transition_num)

    def __len__(self) -> int:
        return len(self.indices)

    @property
    def step_size(self) -> int:
        return self.observation_dim + self.action_dim + 1

    def postprocess_obs_and_act(self, obs: ObsTree, act: np.ndarray):
        """-> ((o_text, o_image, o_tensor) trees, act_tokens)."""
        enc = tree_map(
            lambda x, t, d: self.tok.encode_obs_leaf(np.asarray(x), t, d),
            obs, self.obs_type_spec, self.observation_dims_for_spec,
        )
        if isinstance(enc, dict):
            o_text = {k: v[0] for k, v in enc.items()}
            o_image = {k: v[1] for k, v in enc.items()}
            o_tensor = {k: v[2] for k, v in enc.items()}
        else:
            o_text, o_image, o_tensor = enc
        return (o_text, o_image, o_tensor), self.tok.encode_action(
            np.asarray(act))

    def assemble_obs_tokens(self, o_text, o_image, o_tensor):
        """Concat obs token streams in the canonical order (text, image
        placeholders, then tensor leaves). Returns (obs_tokens [T,
        obs_dim] with -1 image slots, image [T, C, H, W] or None)."""
        parts = [leaf for leaf in (tree_leaves(o_text) if o_text is not None
                                   else []) if leaf is not None]
        image = None
        img_leaves = [
            v for v in (tree_leaves(o_image) if o_image is not None else [])
            if v is not None
        ]
        assert len(img_leaves) <= 1, "only one image obs supported"
        if img_leaves:
            image = np.asarray(img_leaves[0])
            n, _, h, w = image.shape
            p = self.tok.vision_patch_size
            parts.append(np.full((n, (h // p) * (w // p)), -1, np.int64))
        parts += [leaf for leaf in tree_leaves(o_tensor) if leaf is not None]
        return np.concatenate(parts, axis=1).astype(np.int64), image

    def prepend_prompt(self, path_idx: int, obs: ObsTree, act: np.ndarray):
        """With probability ``prompt_prob``, prepend ``prompt_transition_num``
        transitions of trajectory ``path_idx`` (its final ones with
        probability ``prompt_at_final_transition_prob``, else a random
        subsequence or random timesteps) and clip the sample's own window to
        ``predicted_transition_num``. Returns (obs, act, prepended count)."""
        prepend = 0
        if path_idx >= 0 and self.rng.random() < self.prompt_prob:
            obs_traj, act_traj = self.store.get(path_idx)
            path_length = int(self.store.path_lengths[path_idx])
            if self.rng.random() < self.prompt_at_final_transition_prob:
                t_obs = tree_map(
                    lambda x: x[-self.prompt_transition_num:], obs_traj)
                t_act = act_traj[-self.prompt_transition_num:]
            elif self.prompt_strategy == "stochastic_timestep":
                k = min(self.prompt_transition_num, path_length)
                idx = np.sort(self.rng.choice(path_length, k, replace=False))
                t_obs = tree_map(lambda x: x[idx], obs_traj)
                t_act = act_traj[idx]
            else:  # stochastic_subseq
                start = self.rng.choice(
                    max(path_length - self.prompt_transition_num, 1))
                t_obs = tree_map(
                    lambda x: x[start: start + self.prompt_transition_num],
                    obs_traj)
                t_act = act_traj[start: start + self.prompt_transition_num]
            prepend = len(t_act)

            # clip the original window to the predicted budget
            offset_range = max(0, len(act) - self.predicted_transition_num)
            offset = self.rng.choice(offset_range) if offset_range > 0 else 0
            obs = tree_map(
                lambda x: x[offset: offset + self.predicted_transition_num],
                obs)
            act = act[offset: offset + self.predicted_transition_num]
            obs = tree_map(
                lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)], 0),
                t_obs, obs)
            act = np.concatenate([np.asarray(t_act), np.asarray(act)], axis=0)
        return obs, act, prepend

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        """Sample ``idx``: the window of ``transition_num`` transitions at
        its index row, prompt-conditioned when ``use_prompt``, packed to
        ``seq_length + 1`` tokens and split into ``tokens`` / ``label``
        (int32), ``loss_mask`` (f32: action tokens outside the prompt and
        before the trajectory's end) and ``position_id`` (int32); with an
        image observation also ``images`` [transition_num, H, W, C] f32,
        the frames zero-padded to transition_num and the obs slots of the
        padded transitions -1."""
        idx = idx % len(self.indices)
        path_idx, start, end = (int(v) for v in self.indices[idx])
        path_length = int(self.store.path_lengths[path_idx])
        obs, act = self.store.get(path_idx, start, end)

        if self.use_prompt:
            rand_path = int(self.rng.choice(self.store.num_trajectories))
            obs, act, prepend = self.prepend_prompt(rand_path, obs, act)
        else:
            prepend = 0

        (o_text, o_image, o_tensor), act_tok = self.postprocess_obs_and_act(
            obs, act)
        obs_tok, image = self.assemble_obs_tokens(o_text, o_image, o_tensor)

        T = obs_tok.shape[0]
        sep = np.full((T, 1), self.tok.layout.separator_id, dtype=np.int64)
        joined = np.concatenate([obs_tok, sep, act_tok], axis=1).reshape(-1)

        flags, pos = action_flags_and_position_ids(
            len(joined), self.observation_dim, self.action_dim, prepend)
        if end > path_length:
            # transitions past the true end carry no loss
            flags[(path_length - start) * self.step_size:] = 0

        L = self.output_sequence_length + 1
        joined = truncate_or_pad(joined, L)
        flags = truncate_or_pad(flags, L)
        pos = truncate_or_pad(pos, L)
        out = {
            "tokens": joined[:-1].astype(np.int32),
            "label": joined[1:].astype(np.int32),
            "loss_mask": flags[1:].astype(np.float32),
            "position_id": pos[:-1].astype(np.int32),
        }
        if image is not None:
            n = image.shape[0]
            if n < self.transition_num:
                padded = np.zeros(
                    (self.transition_num,) + image.shape[1:], np.float32)
                padded[:n] = image
                image = padded
            for i in range(T, self.transition_num):
                lo = i * self.step_size
                hi = min(L - 1, lo + self.observation_dim)
                out["tokens"][lo:hi] = -1
            out["images"] = np.transpose(
                image.astype(np.float32), (0, 2, 3, 1))      # CHW -> HWC
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.get(idx)

    def sample_expert_demonstration(
        self, strategy: str, strict_length: bool, sample_peak: bool,
        rng: Optional[np.random.RandomState] = None,
    ) -> Dict[str, Any]:
        """An expert prompt: ``transition_num`` transitions (or
        ``prompt_transition_num`` for ``fixed_prompt``) from a top-return
        trajectory, topped up with further trajectories under
        ``strict_length``."""
        rng = rng or self.rng
        prompt_length = (
            self.prompt_transition_num if strategy == "fixed_prompt"
            else self.transition_num
        )
        if sample_peak:
            stop = max(1, int(self.store.num_trajectories * 0.1))
            candidates = self._ret_order[:stop]
        else:
            candidates = np.arange(self.store.num_trajectories)

        path_idx = int(rng.choice(candidates))
        obs_traj, act_traj = self.store.get(path_idx)
        if strict_length:
            obs_list, act_list = [obs_traj], [act_traj]
            total = len(act_traj)
            while total < prompt_length:
                path_idx = int(rng.choice(candidates))
                o, a = self.store.get(path_idx)
                obs_list.append(o)
                act_list.append(a)
                total += len(a)
            if len(obs_list) > 1:
                if isinstance(obs_traj, dict):
                    obs_traj = {
                        k: np.concatenate([np.asarray(o[k]) for o in obs_list])
                        for k in sorted(obs_traj)
                    }
                else:
                    obs_traj = np.concatenate(
                        [np.asarray(o) for o in obs_list])
                act_traj = np.concatenate([np.asarray(a) for a in act_list])

        obs = tree_map(lambda x: np.asarray(x[:prompt_length]), obs_traj)
        act = np.asarray(act_traj[:prompt_length])
        (o_text, o_image, o_tensor), act_tok = self.postprocess_obs_and_act(
            obs, act)
        return {
            "actions": act_tok,
            "obs/text": o_text,
            "obs/image": o_image,
            "obs/tensor": o_tensor,
        }


class RLDataset:
    """Subset view over an RLFullDataset's sample indices (one split)."""

    def __init__(self, full: RLFullDataset, indices: np.ndarray):
        self.full = full
        self.indices = np.asarray(indices)
        assert len(self.indices) == 0 or (
            self.indices.max() < len(full) and self.indices.min() >= 0)

    @property
    def name(self) -> str:
        return self.full.name

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.full.get(int(self.indices[idx % len(self.indices)]))
        item["modality"] = "rl"
        return item


class RLFinetuneDataset(RLDataset):
    """Few-shot view: the samples of the first ``num_shots`` trajectories
    only."""

    def __init__(self, full: RLFullDataset, num_shots: int):
        indices = np.nonzero(np.asarray(full.indices[:, 0]) < num_shots)[0]
        if not len(indices):
            raise ValueError(f"no samples within the first {num_shots} "
                             "trajectories")
        super().__init__(full, indices)


def split_rl_dataset(full: RLFullDataset, splits_string: str = "90,5,5",
                     seed: int = 1234):
    """Shuffle the sample indices once and split them into (train, valid,
    test) views; an empty split is None."""
    n = len(full)
    perm = np.random.RandomState(seed).permutation(n)
    cuts = get_train_valid_test_split_(splits_string, n)
    out = []
    for i in range(3):
        sel = perm[cuts[i]: cuts[i + 1]]
        out.append(RLDataset(full, sel) if len(sel) else None)
    return tuple(out)


def build_rl_dataset_from_cache(
    env_name: str,
    cache_dir: str,
    seq_length: int,
    tokenizer: RLTokenizerSuite,
    **kwargs,
) -> RLFullDataset:
    """The dataset of ``env_name`` from its reference-format cache under
    ``cache_dir`` (built from the live env first when absent,
    ``TrajectoryStore.from_env_name``), with its meta cached there too."""
    store = TrajectoryStore.from_env_name(env_name, cache_dir)
    return RLFullDataset(env_name, store, tokenizer, seq_length,
                         cache_dir=cache_dir, **kwargs)


def make_rl_creator(tokenizer: RLTokenizerSuite, cache_dir: str,
                    suite_envs: Optional[Callable[[str], List[str]]] = None,
                    num_fewshot_episodes: Optional[int] = None,
                    **ds_kwargs):
    """The dataset factory's creators for the types "rl" and
    "rl_task_suite": (rl_creator, suite_creator).

    "rl": the prefix is an env name, its dataset read from the trajectory
    cache under ``cache_dir`` (``ds_kwargs`` go to ``RLFullDataset``) and
    split by ``split_rl_dataset``; with ``num_fewshot_episodes`` the train
    split is the few-shot view of the first N trajectories. "rl_task_suite":
    the prefix is a suite, ``suite_envs(suite)`` its env names (default:
    d4rl's ``ALL_ENVS``, which needs d4rl); each split blends the envs'
    splits in index mode with equal weights."""

    def rl_creator(prefix, splits_string, seq_length, num_samples, seed,
                   **_ctx):
        full = build_rl_dataset_from_cache(
            prefix, cache_dir, seq_length, tokenizer, seed=seed, **ds_kwargs)
        tr, va, te = split_rl_dataset(full, splits_string, seed)
        if num_fewshot_episodes:
            tr = RLFinetuneDataset(full, num_fewshot_episodes)
        return tr, va, te

    def suite_creator(prefix, splits_string, seq_length, num_samples, seed,
                      **_ctx):
        if suite_envs is not None:
            envs = suite_envs(prefix)
        else:
            import importlib

            envs = importlib.import_module(f"d4rl.{prefix}").ALL_ENVS
        parts = [rl_creator(e, splits_string, seq_length, num_samples, seed)
                 for e in envs]
        out = []
        for i in range(3):
            live = [p[i] for p in parts if p[i] is not None]
            if not live:
                out.append(None)
            elif len(live) == 1:
                out.append(live[0])
            else:
                out.append(BlendableDataset(
                    live, [1.0] * len(live), mode="index",
                    size=sum(len(d) for d in live), seed=seed))
        return tuple(out)

    return rl_creator, suite_creator
