"""Minimal gym-style env protocol, the continuous, discrete, image and
text fake envs and the env registry (copy of bdm_db1_tpu/eval/envs.py).

Real gym/d4rl envs stay pluggable (anything with reset/step/spaces works;
``make_env`` falls back to ``gym.make`` when gym is installed); the
deterministic fakes give the eval loop an offline target and write
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
                 episode_len: int = 20, seed: int = 0,
                 walk_sigma: float = 0.0):
        self.observation_space = BoxSpace((obs_dim,))
        self.action_space = BoxSpace((act_dim,))
        self.episode_len = episode_len
        # walk_sigma > 0: observations follow a bounded random walk instead
        # of i.i.d. resampling, so the expert action drifts slowly (the
        # smoothness that the speculative decoder's guess from the previous
        # action relies on)
        self.walk_sigma = float(walk_sigma)
        rng = np.random.RandomState(seed)
        self._w = rng.uniform(-0.3, 0.3, (obs_dim, act_dim)).astype(np.float32)
        self._rng = np.random.RandomState(seed + 1)
        self._t = 0
        self._obs = None

    def expert_action(self, obs: np.ndarray) -> np.ndarray:
        return np.clip(np.tanh(obs @ self._w), -1, 1).astype(np.float32)

    def _next_obs(self) -> np.ndarray:
        if self.walk_sigma and self._obs is not None:
            step = self._rng.randn(
                *self.observation_space.shape).astype(np.float32)
            return np.clip(self._obs + self.walk_sigma * step, -1, 1)
        return self._rng.uniform(
            -1, 1, self.observation_space.shape).astype(np.float32)

    def reset(self) -> np.ndarray:
        self._t = 0
        self._obs = None  # a walk restarts from a fresh uniform draw
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


class FakeContinuousImageEnv:
    """Image observation + multi-dim continuous action (carracing-like):
    exercises the image-prime decode paths for speculable (multi-token)
    actions — image frames in the episode-start prompt AND per-step obs."""

    def __init__(self, hw: int = 32, act_dim: int = 2,
                 episode_len: int = 8, seed: int = 0):
        self.observation_space = BoxSpace((3, hw, hw))
        self.action_space = BoxSpace((act_dim,))
        self.episode_len = episode_len
        self.hw = hw
        self._rng = np.random.RandomState(seed)
        self._t = 0

    def _next_obs(self) -> np.ndarray:
        return self._rng.rand(3, self.hw, self.hw).astype(np.float32)

    def reset(self):
        self._t = 0
        self._obs = self._next_obs()
        return self._obs

    def step(self, action):
        action = np.asarray(action, dtype=np.float32)
        reward = float(-np.linalg.norm(action))
        self._t += 1
        self._obs = self._next_obs()
        return self._obs, reward, self._t >= self.episode_len, {}

    def seed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    def make_dataset(self, num_episodes: int = 4) -> Dict[str, np.ndarray]:
        obs_l, act_l, rew_l, term_l = [], [], [], []
        for _ in range(num_episodes):
            o = self.reset()
            done = False
            while not done:
                a = self._rng.uniform(
                    -1, 1, self.action_space.shape).astype(np.float32)
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


class FakeDiscreteEnv:
    """Deterministic discrete env: reward 1 when action == obs % n_actions."""

    def __init__(self, obs_dim: int = 3, n_actions: int = 4,
                 episode_len: int = 15, seed: int = 0):
        self.observation_space = BoxSpace((obs_dim,))
        self.action_space = DiscreteSpace(n_actions)
        self.episode_len = episode_len
        self._rng = np.random.RandomState(seed)
        self._t = 0
        self._obs = None

    def expert_action(self, obs: np.ndarray) -> int:
        return int(abs(int(obs.sum()))) % self.action_space.n

    def _next_obs(self) -> np.ndarray:
        return self._rng.randint(0, 8, self.observation_space.shape).astype(
            np.int64)

    def reset(self):
        self._t = 0
        self._obs = self._next_obs()
        return self._obs

    def step(self, action):
        reward = float(int(action) == self.expert_action(self._obs))
        self._t += 1
        self._obs = self._next_obs()
        done = self._t >= self.episode_len
        return self._obs, reward, done, {}

    def seed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    def make_dataset(self, num_episodes: int = 10) -> Dict[str, np.ndarray]:
        obs_l, act_l, rew_l, term_l = [], [], [], []
        for _ in range(num_episodes):
            o = self.reset()
            done = False
            while not done:
                a = self.expert_action(o)
                obs_l.append(o)
                act_l.append(a)
                o, r, done, _ = self.step(a)
                rew_l.append(r)
                term_l.append(done)
        return {
            "observations": np.asarray(obs_l, dtype=np.int64),
            "actions": np.asarray(act_l, dtype=np.int64),
            "rewards": np.asarray(rew_l, dtype=np.float32),
            "terminals": np.asarray(term_l, dtype=bool),
        }


class FakeImageEnv:
    """Atari-like env: image observation (CHW float), discrete actions."""

    def __init__(self, hw: int = 32, n_actions: int = 4,
                 episode_len: int = 8, seed: int = 0):
        self.observation_space = BoxSpace((3, hw, hw))
        self.action_space = DiscreteSpace(n_actions)
        self.episode_len = episode_len
        self.hw = hw
        self._rng = np.random.RandomState(seed)
        self._t = 0

    def _next_obs(self) -> np.ndarray:
        return self._rng.rand(3, self.hw, self.hw).astype(np.float32)

    def reset(self):
        self._t = 0
        self._obs = self._next_obs()
        return self._obs

    def step(self, action):
        self._t += 1
        self._obs = self._next_obs()
        return self._obs, 1.0, self._t >= self.episode_len, {}

    def seed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    def make_dataset(self, num_episodes: int = 4) -> Dict[str, np.ndarray]:
        obs_l, act_l, rew_l, term_l = [], [], [], []
        for _ in range(num_episodes):
            o = self.reset()
            done = False
            while not done:
                a = int(self._rng.randint(self.action_space.n))
                obs_l.append(o)
                act_l.append(a)
                o, r, done, _ = self.step(a)
                rew_l.append(r)
                term_l.append(done)
        return {
            "observations": np.asarray(obs_l, dtype=np.float32),
            "actions": np.asarray(act_l, dtype=np.int64),
            "rewards": np.asarray(rew_l, dtype=np.float32),
            "terminals": np.asarray(term_l, dtype=bool),
        }


class FakeTextEnv:
    """BabyAI-like env: dict observation {"mission": instruction string,
    "image": RGB frame}, discrete actions. Missions are drawn per episode
    from templates of one byte length, so every episode tokenizes to the
    same observation geometry."""

    MISSIONS = (
        "go to the red ball",
        "go to the blue key",
        "go to the grey box",
        "pick up a red ball",
        "pick up a blue key",
        "open the neardoor1",
    )

    def __init__(self, hw: int = 32, n_actions: int = 7,
                 episode_len: int = 8, seed: int = 0):
        assert len({len(m) for m in self.MISSIONS}) == 1, (
            "missions must share a tokenized length")
        self.observation_space = BoxSpace((3, hw, hw))
        self.action_space = DiscreteSpace(n_actions)
        self.episode_len = episode_len
        self.hw = hw
        self._rng = np.random.RandomState(seed)
        self._t = 0
        self._mission = self.MISSIONS[0]

    def _next_obs(self):
        return {
            "mission": np.str_(self._mission),
            "image": self._rng.rand(3, self.hw, self.hw).astype(np.float32),
        }

    def reset(self):
        self._t = 0
        self._mission = self.MISSIONS[
            self._rng.randint(len(self.MISSIONS))]
        self._obs = self._next_obs()
        return self._obs

    def step(self, action):
        self._t += 1
        reward = float(int(action) == (self._t % self.action_space.n))
        self._obs = self._next_obs()
        return self._obs, reward, self._t >= self.episode_len, {}

    def seed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    def make_dataset(self, num_episodes: int = 4):
        mis_l, img_l, act_l, rew_l, term_l = [], [], [], [], []
        for _ in range(num_episodes):
            o = self.reset()
            done = False
            while not done:
                a = int(self._rng.randint(self.action_space.n))
                mis_l.append(str(o["mission"]))
                img_l.append(o["image"])
                act_l.append(a)
                o, r, done, _ = self.step(a)
                rew_l.append(r)
                term_l.append(done)
        return {
            "observations": {
                "mission": np.asarray(mis_l),
                "image": np.asarray(img_l, dtype=np.float32),
            },
            "actions": np.asarray(act_l, dtype=np.int64),
            "rewards": np.asarray(rew_l, dtype=np.float32),
            "terminals": np.asarray(term_l, dtype=bool),
        }


_ENV_REGISTRY = {}


def register_env(name: str, factory) -> None:
    _ENV_REGISTRY[name] = factory


def make_env(name: str):
    """Resolve an env: registry first, then gym/d4rl if installed."""
    if name in _ENV_REGISTRY:
        return _ENV_REGISTRY[name]()
    try:
        import gym

        return gym.make(name)
    except Exception as e:
        raise ValueError(f"unknown env {name!r} and gym unavailable: {e}")


register_env("fake-continuous-v0", FakeContinuousEnv)
register_env("fake-discrete-v0", FakeDiscreteEnv)
register_env("fake-image-v0", FakeImageEnv)
register_env("fake-text-v0", FakeTextEnv)
