"""Numerical-health tooling (counterpart of bdm_db1_tpu/utils/debugging.py):
the reference's ``check_nan`` parameter scanner (reference:
src/model/utils.py:31-47), its loss-overflow warning (reference:
src/model/transformer_xl.py:610-611), and a one-scalar finiteness probe on
the device, cheap enough to run every step.

Trees are nested dicts, lists and tuples of tensors or arrays; a path is
named as the JAX package names it (``params['a']['b']``, ``[0]`` for a
list item).
"""

from __future__ import annotations

from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

from bdm_db1_tpu_torch.core.logging import process_index


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _print_with_rank(msg: str) -> None:
    print(f"[rank {process_index()}] {msg}", flush=True)


def check_nan(tree: Any, prefix: str = "params") -> List[str]:
    """Host-side scan: the paths of the leaves holding a non-finite value,
    with a warning printed for each (reference: model/utils.py:31-47)."""
    bad = []
    for path, leaf in _leaves(tree):
        arr = (leaf.detach().float().cpu().numpy()
               if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
        if np.issubdtype(arr.dtype, np.number) and not np.isfinite(arr).all():
            bad.append(prefix + path)
            _print_with_rank(f"WARNING: non-finite values in {prefix + path}")
    return bad


def global_finite(tree: Any) -> torch.Tensor:
    """A bool scalar tensor on the leaves' device, True iff every floating
    leaf is finite. No host sync: read it when the answer is needed."""
    flags = [torch.isfinite(x).all() for _, x in _leaves(tree)
             if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    dev = flags[0].device
    return torch.stack([f.to(dev) for f in flags]).all()


def warn_on_overflow(loss) -> None:
    """Host check after a step (reference: transformer_xl.py:610-611)."""
    if not np.isfinite(float(loss)):
        _print_with_rank("WARNING: Loss Overflow.")
