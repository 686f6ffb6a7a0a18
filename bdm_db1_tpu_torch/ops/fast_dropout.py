"""Dropout drawn from an explicit ``torch.Generator`` (counterpart of
bdm_db1_tpu/ops/fast_dropout.py and of ``_dropout`` in
bdm_db1_tpu/models/transformer_xl.py).

Two implementations, picked by ``ModelConfig.dropout_impl``:

* ``"flax"`` (``nn.Dropout``): keep each element with probability
  1 - rate, scale the survivors by 1 / (1 - rate).
* ``"u8"`` (``dropout_u8``): one random byte an element; keep it iff the
  byte is < ``keep_q = round((1 - rate) * 256)`` and scale the survivors by
  256 / keep_q, so the op stays unbiased at the quantized keep probability
  (rate 0.1 keeps 230/256).

Both draw from the generator they are given, never from the global one
(``F.dropout`` takes no generator), so a seeded generator gives the same
masks again. The bits are torch's, not JAX's: the two packages agree in
distribution, not mask for mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor
# (dim, offset, whole size): x is the slice [offset, offset + x.shape[dim])
# of a tensor of that size along dim; the draw is the whole tensor's,
# narrowed to the slice (the sequence-sharded trunk: each rank of a model
# group holds a part of an activation and draws that part of the
# one-process mask)
Shard = Optional[Tuple[int, int, int]]


def sharded_draw(x: Tensor, shard: Shard, fn) -> Tensor:
    """``fn(shape)`` at x's shape, or at the whole shape narrowed to x's
    slice."""
    if shard is None:
        return fn(x.shape)
    dim, offset, size = shard
    shape = list(x.shape)
    shape[dim] = size
    return fn(shape).narrow(dim, offset, x.shape[dim])


def dropout_flax(x: Tensor, rate: float, generator: torch.Generator,
                 shard: Shard = None) -> Tensor:
    """Keep with probability 1 - rate, survivors divided by 1 - rate."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = sharded_draw(x, shard, lambda shape: torch.rand(
        shape, generator=generator, device=x.device)) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def dropout_u8(x: Tensor, rate: float, generator: torch.Generator,
               shard: Shard = None) -> Tensor:
    """Byte-granular dropout: keep iff a random byte < round((1 - rate) *
    256), survivors scaled by 256 / keep_q."""
    keep_q = int(round((1.0 - rate) * 256.0))
    if keep_q >= 256:
        return x
    if keep_q <= 0:
        return torch.zeros_like(x)
    bits = sharded_draw(x, shard, lambda shape: torch.randint(
        0, 256, shape, dtype=torch.uint8, generator=generator,
        device=x.device))
    scale = torch.tensor(256.0 / keep_q, dtype=x.dtype, device=x.device)
    return torch.where(bits < keep_q, x * scale,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: Tensor, rate: float, generator: torch.Generator,
            impl: str = "flax", shard: Shard = None) -> Tensor:
    """Training-mode dropout by ``impl`` ("flax" or "u8"). A rate of 0 is
    the identity and draws nothing; any other rate needs a generator.
    ``shard``: x is a slice of a larger tensor (:data:`Shard`)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout draws from an explicit torch.Generator; "
                         "none was given")
    if impl == "u8":
        return dropout_u8(x, rate, generator, shard)
    if impl != "flax":
        raise ValueError(f"dropout_impl={impl!r}; the port takes 'flax' and "
                         "'u8'")
    return dropout_flax(x, rate, generator, shard)
