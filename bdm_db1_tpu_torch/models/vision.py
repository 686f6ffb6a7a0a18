"""Gato vision patch embedder (counterpart of bdm_db1_tpu/models/vision.py).

Per image ``[H, W, C]`` (batches stay NHWC, as the JAX batches are; the
module permutes each patch to NCHW for its convolutions):

  1. split into ``patch_size`` x ``patch_size`` patches;
  2. per patch and channel, normalise to mean 0 and std 1 (unbiased std,
     1e-6 added to the std), then divide by sqrt(patch_size);
  3. a ResNet-v2-style block run **per patch** (the 3x3 padding sits at
     every patch border): conv3x3 -> (GroupNorm 32 + GELU + conv3x3) x 2,
     added to the first conv's output;
  4. a stride-``patch_size`` convolution projects each patch to the
     embedding width;
  5. row and column position embeddings, quantised to a 128-entry table:
     the patch interval's midpoint at eval, uniform in ``[low, high)`` in
     training, drawn from the caller's ``torch.Generator``.

Parameter names are the reference torch model's (``patch_embeddings.conv1``,
``patch_embeddings.residual_path.{0,2,3,5}`` with the GELUs at 1 and 4,
``patch_embeddings.projection``, ``row_position_embeddings``,
``col_position_embeddings``), so a DeepSpeed state dict loads with
``strict=True``. The convolutions and the GroupNorm are ``F.conv2d`` and
``F.group_norm``, as they are XLA ops (not Pallas kernels) in the JAX
package; the GroupNorm statistics are taken in f32, as flax takes them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from bdm_db1_tpu_torch.core.config import ModelConfig, VisionConfig
from bdm_db1_tpu_torch.models.activations import gelu
from bdm_db1_tpu_torch.models.utils import init_normal

Tensor = torch.Tensor
GN_GROUPS = 32
GN_EPS = 1e-5
CONV_CHANNELS = 64


class _Act(nn.Module):
    """The parameterless GELU slots of ``residual_path``."""

    def forward(self, x: Tensor) -> Tensor:
        return gelu(x)


def _conv(c_in: int, c_out: int, k: int, stride: int, device, dtype):
    return torch.nn.utils.skip_init(nn.Conv2d, c_in, c_out, k, stride=stride,
                                    device=device, dtype=dtype)


def _group_norm(x: Tensor, gn: nn.GroupNorm) -> Tensor:
    """GroupNorm with f32 statistics, cast back to the input's dtype."""
    return F.group_norm(x.float(), gn.num_groups, gn.weight.float(),
                        gn.bias.float(), gn.eps).to(x.dtype)


class PatchEmbeddings(nn.Module):
    """[B, H, W, C] -> [B, (H/p)(W/p), D]."""

    def __init__(self, cfg: ModelConfig, vision: VisionConfig, device,
                 dtype):
        super().__init__()
        self.cfg, self.vision = cfg, vision
        c, ch = vision.num_input_channels, CONV_CHANNELS
        self.conv1 = _conv(c, ch, 3, 1, device, dtype)
        self.residual_path = nn.Sequential(
            nn.GroupNorm(GN_GROUPS, ch, eps=GN_EPS, device=device,
                         dtype=dtype),
            _Act(),
            _conv(ch, ch, 3, 1, device, dtype),
            nn.GroupNorm(GN_GROUPS, ch, eps=GN_EPS, device=device,
                         dtype=dtype),
            _Act(),
            _conv(ch, ch, 3, 1, device, dtype))
        p = vision.patch_size
        self.projection = _conv(ch, cfg.n_embed, p, p, device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's defaults: lecun-normal kernels (std 1/sqrt(fan in), not
        truncated here), zero biases, unit GroupNorm scales."""
        gn1, _, conv2, gn2, _, conv3 = self.residual_path
        for conv in (self.conv1, conv2, conv3, self.projection):
            fan_in = conv.weight[0].numel()
            init_normal(1.0 / math.sqrt(fan_in))(conv.weight, gen)
            conv.bias.zero_()
        for gn in (gn1, gn2):
            gn.weight.fill_(1.0)
            gn.bias.zero_()

    def forward(self, pixels: Tensor) -> Tensor:
        p = self.vision.patch_size
        b, h, w, c = pixels.shape
        h0, w0 = h // p, w // p
        dtype = getattr(torch, self.cfg.dtype)
        # patchify: [B, h0, p, w0, p, C] -> [B h0 w0, p, p, C]
        x = pixels.reshape(b, h0, p, w0, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b * h0 * w0, p, p, c).float()
        # per-patch, per-channel normalisation, unbiased std
        mean = x.mean(dim=(1, 2), keepdim=True)
        std = x.var(dim=(1, 2), keepdim=True, unbiased=True).sqrt()
        x = (x - mean) / (1e-6 + std) / math.sqrt(float(p))
        x = x.to(dtype).permute(0, 3, 1, 2)                  # NCHW per patch
        gn1, _, conv2, gn2, _, conv3 = self.residual_path

        def conv(t, m, **kw):
            return F.conv2d(t, m.weight.to(dtype), m.bias.to(dtype), **kw)

        x = conv(x, self.conv1, padding=1)
        res = x
        x = conv(gelu(_group_norm(x, gn1)), conv2, padding=1)
        x = conv(gelu(_group_norm(x, gn2)), conv3, padding=1)
        x = conv(res + x, self.projection, stride=p)         # [N, D, 1, 1]
        return x.reshape(b, h0 * w0, self.cfg.n_embed)


class VisionEmbedding(nn.Module):
    """[B, H, W, C] -> [B, S, D] patch embeddings with position codes."""

    def __init__(self, cfg: ModelConfig, vision: VisionConfig, device,
                 dtype):
        super().__init__()
        self.cfg, self.vision = cfg, vision
        self.patch_embeddings = PatchEmbeddings(cfg, vision, device, dtype)
        pv = vision.position_vocab_size
        self.row_position_embeddings = torch.nn.utils.skip_init(
            nn.Embedding, pv, cfg.n_embed, device=device, dtype=dtype)
        self.col_position_embeddings = torch.nn.utils.skip_init(
            nn.Embedding, pv, cfg.n_embed, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.patch_embeddings.reset_parameters(gen)
        for table in (self.row_position_embeddings,
                      self.col_position_embeddings):
            init_normal(0.02)(table.weight, gen)

    def position_ids(self, b: int, h0: int, w0: int, deterministic: bool,
                     generator: Optional[torch.Generator], device):
        """(row ids, col ids) [B, h0 w0]: the interval midpoints at eval,
        uniform draws in [low, high) in training."""
        pv = self.vision.position_vocab_size
        seq = torch.arange(h0 * w0, device=device)
        row, col = seq // w0, seq % w0
        # f32 arithmetic truncated to int, as the JAX package computes it
        row_low = (row / h0 * pv).to(torch.int64)
        row_high = ((row + 1) / h0 * pv).to(torch.int64)
        col_low = (col / w0 * pv).to(torch.int64)
        col_high = ((col + 1) / w0 * pv).to(torch.int64)
        if deterministic:
            return (((row_low + row_high) // 2).expand(b, -1),
                    ((col_low + col_high) // 2).expand(b, -1))
        if generator is None:
            raise ValueError("random patch positions need the training "
                             "torch.Generator")

        def draw(low, high):
            u = torch.rand((b, low.shape[0]), generator=generator,
                           device=device)
            ids = low + (u * (high - low)).to(torch.int64)
            return torch.minimum(ids, torch.maximum(high - 1, low))

        return draw(row_low, row_high), draw(col_low, col_high)

    def forward(self, pixels: Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Tensor:
        p = self.vision.patch_size
        b, h, w, _ = pixels.shape
        dtype = getattr(torch, self.cfg.dtype)
        emb = self.patch_embeddings(pixels)
        row_ids, col_ids = self.position_ids(b, h // p, w // p,
                                             deterministic, generator,
                                             pixels.device)
        return (emb
                + F.embedding(row_ids,
                              self.row_position_embeddings.weight.to(dtype))
                + F.embedding(col_ids,
                              self.col_position_embeddings.weight.to(dtype)))
