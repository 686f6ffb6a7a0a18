"""Per-env random/expert return baselines for expert-normalized scoring (a
copy of bdm_db1_tpu/eval/baselines.py).

The reference's headline metric — "≥50% expert score on 76% of 870 tasks"
(reference: README.md:8) — needs per-env random/expert returns that its
release never ships in one place: d4rl publishes them as
``infos.REF_MIN_SCORE`` / ``REF_MAX_SCORE``, and the reference derives
expert stats from its own datasets' top-return trajectories
(reference: src/data/rl_dataset.py:809-862). This registry unifies the three
sources behind one lookup that :mod:`bdm_db1_tpu_torch.eval.aggregate`
consumes:

* a JSON file ``{env: {"random": r, "expert": e}, ...}``,
* the d4rl score tables (when d4rl is installed),
* a trajectory cache (expert = mean return of the top-return decile, the
  same decile the expert-prompt sampler draws from; random must then come
  from one of the other sources or defaults to 0).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Optional

Baselines = Dict[str, Dict[str, float]]


class BaselineRegistry:
    """env name -> {'random': float, 'expert': float}."""

    def __init__(self, table: Optional[Baselines] = None):
        self.table: Baselines = dict(table or {})

    # -- sources -----------------------------------------------------------
    @classmethod
    def from_json(cls, path: str) -> "BaselineRegistry":
        with open(path) as f:
            raw = json.load(f)
        table = {}
        for env, rec in raw.items():
            table[env] = {"random": float(rec["random"]),
                          "expert": float(rec["expert"])}
        return cls(table)

    @classmethod
    def from_d4rl(cls, env_names: Optional[Iterable[str]] = None
                  ) -> "BaselineRegistry":
        """d4rl's published reference scores (ref_min = random policy,
        ref_max = expert policy). Gated on d4rl being installed."""
        from d4rl import infos  # pragma: no cover — exercised via mock

        names = list(env_names) if env_names is not None else [
            n for n in infos.REF_MIN_SCORE if n in infos.REF_MAX_SCORE]
        table = {
            n: {"random": float(infos.REF_MIN_SCORE[n]),
                "expert": float(infos.REF_MAX_SCORE[n])}
            for n in names
            if n in infos.REF_MIN_SCORE and n in infos.REF_MAX_SCORE
        }
        return cls(table)

    @classmethod
    def from_trajectory_cache(cls, cache_dir: str,
                              env_names: Iterable[str],
                              random_returns: Optional[Dict[str, float]] = None
                              ) -> "BaselineRegistry":
        """Expert returns from the offline datasets themselves: the mean
        return of the top-return decile — the same trajectories the
        expert-prompt sampler draws from (data/rl_dataset.py ``sample_peak``;
        reference: src/data/rl_dataset.py:809-862). ``random_returns``
        supplies the random-policy floor per env (default 0.0)."""
        import numpy as np

        from bdm_db1_tpu_torch.data.rl_dataset import TrajectoryStore

        random_returns = random_returns or {}
        table = {}
        for name in env_names:
            store = TrajectoryStore.from_cache_dir(cache_dir, name)
            rets = np.sort(store.traj_returns)[::-1]
            stop = max(1, int(len(rets) * 0.1))
            table[name] = {
                "random": float(random_returns.get(name, 0.0)),
                "expert": float(rets[:stop].mean()),
            }
        return cls(table)

    # -- ops ---------------------------------------------------------------
    def merge(self, other: "BaselineRegistry") -> "BaselineRegistry":
        """Later sources win (e.g. JSON overrides on top of d4rl)."""
        merged = dict(self.table)
        merged.update(other.table)
        return BaselineRegistry(merged)

    def get(self, env: str) -> Optional[Dict[str, float]]:
        return self.table.get(env)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.table, f, indent=2, sort_keys=True)

    def __len__(self) -> int:
        return len(self.table)

    def __contains__(self, env: str) -> bool:
        return env in self.table
