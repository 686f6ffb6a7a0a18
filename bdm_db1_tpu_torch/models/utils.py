"""Model-side utilities (counterpart of bdm_db1_tpu/models/utils.py): the
normal init factories and stochastic depth.

The factories return in-place initialisers ``init(tensor, generator)``
that draw from an explicit ``torch.Generator``, as every weight of the
port is drawn. ``DropPath`` takes its generator at call time, as the
port's dropout does (ops/fast_dropout.py): the masks are torch's, not
JAX's threefry draws, so the two packages agree in distribution only.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

Init = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def init_normal(sigma: float = 0.02) -> Init:
    """normal(0, sigma), in place."""
    def init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        with torch.no_grad():
            return t.normal_(0.0, sigma, generator=generator)

    return init


def init_scaled_normal(sigma: float, num_layers: int) -> Init:
    """Megatron-style output-layer init: sigma / sqrt(2 * n_layers)."""
    return init_normal(sigma / (2.0 * num_layers) ** 0.5)


class DropPath(nn.Module):
    """Stochastic depth: drop the whole residual branch per sample, one
    keep flag a sample along the leading axis, survivors scaled by
    1 / (1 - rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("DropPath in training needs a torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
