"""Minimal gym-style env protocol and the continuous fake env (copy of the
parts of bdm_db1_tpu/eval/envs.py that the RL-evaluation slice needs).

Real gym/d4rl envs stay pluggable (anything with reset/step/spaces works);
the deterministic fake gives the eval loop an offline target and writes
synthetic expert datasets in d4rl's ``get_dataset`` layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class BoxSpace:
    shape: Tuple[int, ...]
    low: float = -1.0
    high: float = 1.0


@dataclasses.dataclass
class DiscreteSpace:
    n: int

    @property
    def shape(self):
        return ()


def is_discrete_space(space) -> bool:
    """(reference: src/evaluation/evaluate_rl.py judge_discrete_space)."""
    return hasattr(space, "n")


class FakeContinuousEnv:
    """Deterministic continuous-control env (HalfCheetah-like geometry).

    Observation: float vector; reward = -||act - g(obs)|| where g is a fixed
    linear map, so an 'expert' (act = g(obs)) is exactly recoverable — useful
    for end-to-end behavior-cloning sanity checks.
    """

    def __init__(self, obs_dim: int = 5, act_dim: int = 2,
                 episode_len: int = 20, seed: int = 0):
        self.observation_space = BoxSpace((obs_dim,))
        self.action_space = BoxSpace((act_dim,))
        self.episode_len = episode_len
        rng = np.random.RandomState(seed)
        self._w = rng.uniform(-0.3, 0.3, (obs_dim, act_dim)).astype(np.float32)
        self._rng = np.random.RandomState(seed + 1)
        self._t = 0
        self._obs = None

    def expert_action(self, obs: np.ndarray) -> np.ndarray:
        return np.clip(np.tanh(obs @ self._w), -1, 1).astype(np.float32)

    def _next_obs(self) -> np.ndarray:
        return self._rng.uniform(
            -1, 1, self.observation_space.shape).astype(np.float32)

    def reset(self) -> np.ndarray:
        self._t = 0
        self._obs = self._next_obs()
        return self._obs

    def step(self, action):
        action = np.asarray(action, dtype=np.float32)
        reward = float(-np.linalg.norm(action - self.expert_action(self._obs)))
        self._t += 1
        self._obs = self._next_obs()
        done = self._t >= self.episode_len
        return self._obs, reward, done, {}

    def seed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    # -- synthetic expert data in d4rl get_dataset layout ---------------------
    def make_dataset(self, num_episodes: int = 10,
                     noise: float = 0.0) -> Dict[str, np.ndarray]:
        obs_l, act_l, rew_l, term_l = [], [], [], []
        for _ in range(num_episodes):
            o = self.reset()
            done = False
            while not done:
                a = self.expert_action(o)
                if noise:
                    a = np.clip(
                        a + self._rng.randn(*a.shape) * noise, -1, 1
                    ).astype(np.float32)
                obs_l.append(o)
                act_l.append(a)
                o, r, done, _ = self.step(a)
                rew_l.append(r)
                term_l.append(done)
        return {
            "observations": np.asarray(obs_l, dtype=np.float32),
            "actions": np.asarray(act_l, dtype=np.float32),
            "rewards": np.asarray(rew_l, dtype=np.float32),
            "terminals": np.asarray(term_l, dtype=bool),
        }
