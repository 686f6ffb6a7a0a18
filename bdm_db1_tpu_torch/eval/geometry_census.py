"""Decode-geometry census of the 870-env evaluation suite (counterpart of
bdm_db1_tpu/eval/geometry_census.py, the same pure Python).

The reference evaluates every env of 8 task suites
(reference: scripts/evaluate/evaluate_rl_1.2B.sh:51-60, suite lists come
from its private d4rl forks' ``ALL_ENVS``), with per-env obs/action token
lengths computed by ``get_obs_length``
(reference: src/evaluation/evaluate_rl.py:269-283). Each distinct
(obs_length, action_length) pair is a distinct steady-prime width: in the
JAX package a compiled program each, in this port a positional projection
each (``RkCache``, 24 x (1024 + W) x 2048 bf16 values at db1_1p2b) and a
prime shape of its own for the ring kernels.

This module holds the census: per-suite geometry families with env counts
— exact where the suite's spec pins them (image suites tokenize to a
fixed patch count; metaworld is uniformly 39/4), approximated from the
public suite specs where the reference's forks are unavailable
(dmc / modular_rl / babyai instruction lengths; marked ``approx=True``).
It computes, for a given bucket ladder, how many distinct steady-prime
shapes ("programs", the JAX package's word) the whole suite needs:

* WITHOUT coarsening: one per distinct (prime_width, action_length).
* WITH the default ladder (``eval/decode.py DEFAULT_OBS_BUCKETS``): the
  prime pads to a canonical width with query-only rows
  (``decode_rl_kv_ring real_q``), so the count collapses to
  O(#buckets x #action-lengths); the discrete-action logit bias is an
  input, so all n_actions share.

Run ``python -m bdm_db1_tpu_torch.eval.geometry_census`` for the report.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional, Sequence, Tuple

from bdm_db1_tpu_torch.eval.decode import DEFAULT_OBS_BUCKETS, _bucket_for


@dataclasses.dataclass(frozen=True)
class GeometryFamily:
    """A group of envs sharing one decode-geometry *family*.

    ``distinct_obs`` models the within-family spread: how many DISTINCT
    obs-token lengths the family's envs actually have, spread over
    [obs_tokens, obs_max]. babyai instruction lengths and modular_rl
    morphology obs dims differ env by env — that spread, not the family
    count, is what splinters prime shapes without coarsening."""
    suite: str
    family: str          # env family / example env
    n_envs: int
    obs_tokens: int      # tokenized observation length (get_obs_length)
    action_length: int   # tokens per action (1 for discrete)
    discrete: bool
    n_actions: Optional[int] = None   # discrete only (bias operand)
    approx: bool = False  # True: from public suite specs, not the fork
    obs_max: Optional[int] = None     # upper obs length of the spread
    distinct_obs: int = 1             # distinct obs lengths in the family

    def obs_widths(self):
        """The family's distinct obs-token lengths (evenly spread over
        [obs_tokens, obs_max] when more than one)."""
        if self.distinct_obs <= 1 or self.obs_max is None:
            return [self.obs_tokens]
        lo, hi = self.obs_tokens, self.obs_max
        n = self.distinct_obs
        return sorted({round(lo + (hi - lo) * i / (n - 1))
                       for i in range(n)})


# Token accounting (reference: evaluate_rl.py:269-283): image obs ->
# (h/16)*(w/16) patch tokens; float obs -> element count; text obs ->
# BPE length. Image suites resize to 80x80 -> 25 tokens (the reference
# wrapper's vision path; atari/sokoban), procgen ships 64x64 -> 16,
# dmlab 72x96 -> 4*6 = 24. babyai = instruction BPE + 8x8-ish grid
# image; instruction length varies per level family.
SUITE_GEOMETRIES: Tuple[GeometryFamily, ...] = (
    # ---- image suites: obs length pinned by the resize + patch size ----
    GeometryFamily("atari", "ALE games (80x80 RGB, full action set)",
                   51, 25, 1, True, 18),
    GeometryFamily("gym_procgen", "procgen games (64x64 RGB)",
                   16, 16, 1, True, 15),
    GeometryFamily("dmlab", "DMLab levels (72x96 RGB)",
                   20, 24, 1, True, 15, approx=True),
    GeometryFamily("gym_sokoban", "Sokoban variants (80x80 RGB)",
                   6, 25, 1, True, 9, approx=True),
    # ---- babyai: text instruction + 64x64 image; instruction BPE length
    # varies per level — nearly every level is its own obs length ----
    GeometryFamily("babyai", "levels (instr 5-30 BPE + 16 img tokens)",
                   46, 21, 1, True, 7, approx=True,
                   obs_max=46, distinct_obs=24),
    # ---- metaworld: uniform 39-float obs, 4-dim action across MT50 ----
    GeometryFamily("metaworld", "MT50 manipulation", 50, 39, 4, False),
    # ---- dmc: per-domain flat obs dim / action dim (dm_control specs) --
    GeometryFamily("dmc", "acrobot", 2, 6, 1, False, approx=True),
    GeometryFamily("dmc", "ball_in_cup", 2, 8, 2, False, approx=True),
    GeometryFamily("dmc", "cartpole", 4, 5, 1, False, approx=True),
    GeometryFamily("dmc", "cheetah", 1, 17, 6, False, approx=True),
    GeometryFamily("dmc", "finger", 3, 12, 2, False, approx=True),
    GeometryFamily("dmc", "fish", 2, 24, 5, False, approx=True),
    GeometryFamily("dmc", "hopper", 2, 15, 4, False, approx=True),
    GeometryFamily("dmc", "humanoid", 3, 67, 21, False, approx=True),
    GeometryFamily("dmc", "manipulator", 2, 44, 5, False, approx=True),
    GeometryFamily("dmc", "pendulum", 1, 3, 1, False, approx=True),
    GeometryFamily("dmc", "point_mass", 1, 4, 2, False, approx=True),
    GeometryFamily("dmc", "reacher", 2, 6, 2, False, approx=True),
    GeometryFamily("dmc", "swimmer", 2, 25, 5, False, approx=True),
    GeometryFamily("dmc", "walker", 3, 24, 6, False, approx=True),
    # ---- modular_rl: morphology variants ("One Policy to Control Them
    # All"): obs = limbs x per-limb features, act = joint count — every
    # morphology is its own (obs, act) pair ----
    GeometryFamily("modular_rl", "walker morphologies (2-7 limbs)",
                   7, 14, 6, False, approx=True,
                   obs_max=49, distinct_obs=6),
    GeometryFamily("modular_rl", "cheetah morphologies",
                   8, 21, 6, False, approx=True,
                   obs_max=56, distinct_obs=8),
    GeometryFamily("modular_rl", "humanoid morphologies",
                   5, 35, 9, False, approx=True,
                   obs_max=63, distinct_obs=5),
    GeometryFamily("modular_rl", "hopper morphologies",
                   3, 14, 3, False, approx=True,
                   obs_max=28, distinct_obs=3),
)


def families(suites: Optional[Sequence[str]] = None):
    fams = SUITE_GEOMETRIES
    if suites is not None:
        fams = tuple(f for f in fams if f.suite in suites)
    return fams


def steady_prime_width(obs_tokens: int, defers: bool = True) -> int:
    """Steady-state prime: [deferred-action-lead? || obs || sep]."""
    return obs_tokens + 1 + (1 if defers else 0)


def census(buckets=DEFAULT_OBS_BUCKETS, defers: bool = True,
           suites: Optional[Sequence[str]] = None) -> dict:
    """Program/geometry counts for the suite.

    ``decoders``: distinct decode_geometry keys (cheap Python objects).
    ``programs_exact``: distinct steady-prime shapes WITHOUT coarsening —
    one per (prime_width, action_length); the discrete logit bias is an
    input, so n_actions never splits one.
    ``programs_bucketed``: same with each prime width padded up to its
    bucket (widths beyond the ladder keep exact width).
    """
    fams = families(suites)
    decoders = len({(o, f.action_length, f.discrete, f.n_actions)
                    for f in fams for o in f.obs_widths()})
    exact = Counter()
    bucketed = Counter()
    for f in fams:
        widths = f.obs_widths()
        per = f.n_envs / len(widths)
        for o in widths:
            w = steady_prime_width(o, defers)
            exact[(w, f.action_length)] += per
            b = _bucket_for(w, buckets) if buckets else None
            bucketed[(b if b is not None else w, f.action_length)] += per
    return {
        "n_envs": sum(f.n_envs for f in fams),
        "n_families": len(fams),
        "decoders": decoders,
        "programs_exact": len(exact),
        "programs_bucketed": len(bucketed),
        "bucketed_keys": sorted(bucketed),
        "exact_keys": sorted(exact),
    }


def main() -> None:  # pragma: no cover (report CLI)
    rep = census()
    print("decode-geometry census (approximate env counts where the "
          "reference's d4rl forks are unavailable):")
    by_suite = Counter()
    for f in SUITE_GEOMETRIES:
        by_suite[f.suite] += f.n_envs
    for s, n in sorted(by_suite.items()):
        print(f"  {s:>12}: {n} envs")
    print(f"  families: {rep['n_families']}  decoders: {rep['decoders']}")
    print(f"  steady-prime programs, exact widths : "
          f"{rep['programs_exact']}")
    print(f"  steady-prime programs, bucketed     : "
          f"{rep['programs_bucketed']}  (ladder {DEFAULT_OBS_BUCKETS})")
    print(f"  bucketed (width, action_len) keys   : "
          f"{rep['bucketed_keys']}")


if __name__ == "__main__":  # pragma: no cover
    main()
