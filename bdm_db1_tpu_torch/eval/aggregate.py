"""Suite-level score aggregation (a copy of bdm_db1_tpu/eval/aggregate.py).

The reference's headline claim is "≥50% expert score on 76% of 870 tasks"
(reference: README.md:8) but ships only raw per-env returns
(evaluate_rl.py tee'd to results.output). This supplies the aggregation:
expert-normalized scores ``(return - random) / (expert - random)`` and the
fraction of tasks clearing a threshold.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional


def normalized_score(ret: float, random_ret: float, expert_ret: float
                     ) -> float:
    denom = expert_ret - random_ret
    if abs(denom) < 1e-12:
        return 0.0
    return (ret - random_ret) / denom


def aggregate_results(
    results: Iterable[Dict],
    baselines: Dict[str, Dict[str, float]],
    threshold: float = 0.5,
) -> Dict[str, float]:
    """results: dicts with 'env' and 'return_mean' (evaluate_env output).
    baselines: env -> {'random': r, 'expert': e}. Returns the suite summary
    incl. the reference's headline metric (fraction >= threshold)."""
    scores: List[float] = []
    missing = 0
    for res in results:
        b = baselines.get(res["env"])
        if b is None:
            missing += 1
            continue
        scores.append(normalized_score(
            res["return_mean"], b["random"], b["expert"]))
    n = len(scores)
    above = sum(1 for s in scores if s >= threshold)
    return {
        "num_tasks": float(n),
        "num_missing_baselines": float(missing),
        "mean_normalized_score": (sum(scores) / n) if n else 0.0,
        f"fraction_ge_{threshold:g}": (above / n) if n else 0.0,
    }


def load_results_output(path: str) -> List[Dict]:
    """Parse an evaluate_rl results.output (one JSON record per line)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """CLI: results.output + a baselines source -> the headline summary.

        python -m bdm_db1_tpu_torch.eval.aggregate results.output \
            --baselines baselines.json [--d4rl] [--threshold 0.5]

    Produces the reference's README headline ("fraction of tasks >= 50%%
    expert", reference: README.md:8) from the records evaluate_rl writes
    (scripts/evaluate/evaluate_rl_1.2B.sh:91 tees them). ``--d4rl`` pulls
    d4rl's published ref_min/ref_max scores first; ``--baselines`` JSON
    entries override them.
    """
    import argparse

    from bdm_db1_tpu_torch.eval.baselines import BaselineRegistry

    ap = argparse.ArgumentParser("bdm-db1-tpu-torch aggregate")
    ap.add_argument("results", help="results.output path (JSON lines)")
    ap.add_argument("--baselines", default=None,
                    help="JSON file: {env: {random, expert}}")
    ap.add_argument("--d4rl", action="store_true",
                    help="seed the registry from d4rl ref_min/ref_max")
    ap.add_argument("--threshold", type=float, default=0.5)
    args = ap.parse_args(argv)

    reg = BaselineRegistry()
    if args.d4rl:
        reg = reg.merge(BaselineRegistry.from_d4rl())
    if args.baselines:
        reg = reg.merge(BaselineRegistry.from_json(args.baselines))
    summary = aggregate_results(
        load_results_output(args.results), reg.table,
        threshold=args.threshold)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
