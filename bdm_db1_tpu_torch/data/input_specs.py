"""Typed device batches (counterpart of bdm_db1_tpu/data/input_specs.py):
dataclasses of tensors in place of flax pytrees.

Every modality group packs to one sequence length ``L`` and the model
concatenates the groups along the batch. Images are NHWC, as in the JAX
batches; the vision embedder permutes them for its convolutions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass
class RLTaskBatch:
    """Packed decision-transformer sample; image slots hold token id -1."""

    tokens: torch.Tensor                       # [B, L] int
    position_id: torch.Tensor                  # [B, L] int (0 = action)
    loss_mask: Optional[torch.Tensor] = None   # [B, L]
    label: Optional[torch.Tensor] = None       # [B, L] int
    images: Optional[torch.Tensor] = None      # [B, T, H, W, C] float


@dataclass
class NLPTaskBatch:
    """Packed text span: the word embedding alone, no timestep term."""

    tokens: torch.Tensor                       # [B, L] int
    loss_mask: Optional[torch.Tensor] = None   # [B, L]
    label: Optional[torch.Tensor] = None       # [B, L] int


@dataclass
class ICTaskBatch:
    """Image captioning: [prompt | image patches | caption]."""

    prompt: torch.Tensor                       # [B, P] int
    images: torch.Tensor                       # [B, H, W, C] float
    text: torch.Tensor                         # [B, Lt] int
    loss_mask: Optional[torch.Tensor] = None   # [B, L] over the sequence
    label: Optional[torch.Tensor] = None       # [B, L] int


@dataclass
class VQATaskBatch:
    """VQA: [prompt | image patches | question + answer]."""

    prompt: torch.Tensor                       # [B, P] int
    images: torch.Tensor                       # [B, H, W, C] float
    text: torch.Tensor                         # [B, Lt] int
    ques_len: torch.Tensor                     # [B] int
    loss_mask: Optional[torch.Tensor] = None   # [B, L]
    label: Optional[torch.Tensor] = None       # [B, L] int


# A mixed-modality batch: modality group name -> sub-batch.
GatoBatch = Dict[str, object]

MODALITY_ORDER = ("rl", "nlp", "ic", "vqa")
