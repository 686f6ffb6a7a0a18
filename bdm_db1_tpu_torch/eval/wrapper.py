"""Tokenizing env wrapper: raw observations -> unified token sequences
(counterpart of bdm_db1_tpu/eval/wrapper.py).

Tokenizes observations with the dataset's vocab offsets, emits -1
placeholders for image patches beside the frames (NHWC float32), and
builds expert prompts from the dataset's demonstration sampler. Pure
host-side numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from bdm_db1_tpu_torch.data.rl_dataset import RLFullDataset, tree_leaves, tree_map
from bdm_db1_tpu_torch.eval.envs import is_discrete_space


class TokenizedEnv:
    """Wraps a gym-style env with the tokenization of an RLFullDataset."""

    def __init__(self, env, dataset: RLFullDataset,
                 eval_prompt_strategy: str = "moving_prompt"):
        self.env = env
        self.ds = dataset
        self.tok = dataset.tok
        self.eval_prompt_strategy = eval_prompt_strategy
        self.obs_length = int(dataset.observation_dim)
        self.action_length = int(dataset.action_dim)
        self.action_space = env.action_space
        self.observation_space = env.observation_space
        self.discrete_action = is_discrete_space(env.action_space)
        self.separator_id = dataset.tok.layout.separator_id

    # -- per-step tokenization -----------------------------------------------
    def encode_obs(self, raw_obs) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Raw obs -> (token vector [obs_length] with -1 image slots,
        image [1, H, W, C] or None)."""
        obs = tree_map(
            lambda x: np.asarray(x)[None], raw_obs
        )  # add a time axis so dataset-side encoders see [T, ...]
        (o_text, o_image, o_tensor), _ = self.ds.postprocess_obs_and_act(
            obs, self._dummy_action())
        obs_tok, image = self.ds.assemble_obs_tokens(o_text, o_image, o_tensor)
        tokens = obs_tok.reshape(-1)
        assert tokens.shape[0] == self.obs_length, (
            tokens.shape, self.obs_length)
        return tokens, _nhwc(image)

    def encode_obs_batch(
        self, raw_obs_list
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Tokenize B raw observations in one vectorized pass; the encoders
        are elementwise over the leading axis, so this equals B
        :meth:`encode_obs` calls. Returns (tokens [B, obs_length] with -1
        image slots, images [B, H, W, C] or None)."""
        b = len(raw_obs_list)
        first = raw_obs_list[0]
        if isinstance(first, dict):
            obs = {k: np.stack([np.asarray(r[k]) for r in raw_obs_list])
                   for k in sorted(first)}
        else:
            obs = np.stack([np.asarray(r) for r in raw_obs_list])
        (o_text, o_image, o_tensor), _ = self.ds.postprocess_obs_and_act(
            obs, self._dummy_action(b))
        obs_tok, image = self.ds.assemble_obs_tokens(o_text, o_image, o_tensor)
        assert obs_tok.shape == (b, self.obs_length), (
            obs_tok.shape, (b, self.obs_length))
        return obs_tok, _nhwc(image)

    def _dummy_action(self, b: int = 1) -> np.ndarray:
        if self.discrete_action:
            return np.zeros((b,), dtype=np.int64)
        return np.zeros((b,) + self.action_space.shape, dtype=np.float32)

    # -- gym surface ------------------------------------------------------------
    def reset(self):
        raw = self.env.reset()
        tokens, image = self.encode_obs(raw)
        return tokens, image, self.current_action_mask()

    def step(self, action):
        """``env.step`` with the new observation tokenized: (tokens, image,
        action mask, reward, done, info)."""
        raw, reward, done, info = self.env.step(action)
        tokens, image = self.encode_obs(raw)
        return tokens, image, self.current_action_mask(), reward, done, info

    def step_raw(self, action):
        """``env.step`` without tokenization — the lockstep cohort steps
        every env first, then tokenizes the whole batch of raw observations
        in one :meth:`encode_obs_batch` call."""
        raw, reward, done, info = self.env.step(action)
        return raw, reward, done, info, self.current_action_mask()

    def current_action_mask(self) -> Optional[np.ndarray]:
        if hasattr(self.env, "get_cur_action_mask"):
            return self.env.get_cur_action_mask()
        return None

    def seed(self, seed: int) -> None:
        if hasattr(self.env, "seed"):
            self.env.seed(seed)

    # -- expert prompt -------------------------------------------------------------
    def get_prompt(self, strict_length: bool = True,
                   minimal_expert_data: bool = False,
                   rng: Optional[np.random.RandomState] = None):
        """Expert demonstration -> (flattened [obs || sep || act] token
        stream, its frames [T, H, W, C] or None)."""
        demo = self.ds.sample_expert_demonstration(
            strategy=self.eval_prompt_strategy,
            strict_length=strict_length,
            sample_peak=not minimal_expert_data,
            rng=rng,
        )
        obs_tok, image = self.ds.assemble_obs_tokens(
            demo["obs/text"], demo["obs/image"], demo["obs/tensor"])
        act_tok = demo["actions"].reshape(len(obs_tok), -1)
        sep = np.full((len(obs_tok), 1), self.separator_id, dtype=np.int64)
        prompt = np.concatenate([obs_tok, sep, act_tok], axis=1).reshape(-1)
        return prompt, _nhwc(image)


def _nhwc(image: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Dataset frames [T, C, H, W] -> the model's [T, H, W, C] f32."""
    if image is None:
        return None
    return np.transpose(image.astype(np.float32), (0, 2, 3, 1))
