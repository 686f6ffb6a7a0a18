"""Unified multi-modal vocabulary layout (copy of bdm_db1_tpu/core/vocab.py).

The reference scatters the Gato token-id arithmetic across four files
(reference: src/data/rl_dataset.py:412-471, src/evaluation/rl/wrapper.py:53-60,
src/evaluation/evaluate_rl.py:96-138, src/model/transformer_xl.py:377-391).
Here it lives in one immutable object so the dataset code, the gym wrapper,
the decode-time logit masks and the model embedding table can never disagree.

Layout (``overlap_with_text=True``, the shipped default):

    [0, text)                  text BPE ids (discrete env values overlap this range)
    [text, text + n_cont)      continuous bins (mu-law obs / linear action bins)
    text + n_cont              the Gato ``|`` separator
    total = text + n_cont + 1  (= 33,025 for the 1.2B flagship)

With ``overlap_with_text=False`` discrete values get their own block between
text and the continuous bins.

The embedding/LM-head matrices are padded to a multiple of 128 (the JAX
package's layout, kept so the two packages' logits compare element for
element); ``padded_vocab_size`` and the decode masks below account for the
padding tail.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

VOCAB_PAD_MULTIPLE = 128


@dataclasses.dataclass(frozen=True)
class VocabLayout:
    text_vocab_size: int = 32_000
    num_discrete_values: int = 1_024
    num_continuous_bin: int = 1_024
    overlap_with_text: bool = True

    # ---- derived layout -------------------------------------------------
    @cached_property
    def discrete_offset(self) -> int:
        """Token id of discrete env value 0."""
        return 0 if self.overlap_with_text else self.text_vocab_size

    @cached_property
    def continuous_offset(self) -> int:
        """Token id of continuous bin 0."""
        if self.overlap_with_text:
            return self.text_vocab_size
        return self.text_vocab_size + self.num_discrete_values

    @cached_property
    def separator_id(self) -> int:
        return self.continuous_offset + self.num_continuous_bin

    @cached_property
    def total_vocab_size(self) -> int:
        return self.separator_id + 1

    @cached_property
    def padded_vocab_size(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return ((self.total_vocab_size + m - 1) // m) * m

    # ---- raw-value <-> token-id maps ------------------------------------
    def encode_continuous(self, bins):
        """Continuous-tokenizer bin indices -> unified token ids."""
        return bins + self.continuous_offset

    def decode_continuous(self, tokens):
        """Unified token ids -> continuous bin indices."""
        return tokens - self.continuous_offset

    def encode_discrete(self, values):
        """Raw discrete env values -> unified token ids."""
        return values + self.discrete_offset

    def decode_discrete(self, tokens):
        return tokens - self.discrete_offset

    # ---- decode-time logit masks -----------------------------------------
    # Additive biases (0 = allowed, -inf-ish = banned) with the same semantics
    # as the reference `masked_logits_for_action` (evaluate_rl.py:96-124),
    # extended to also ban the padding tail.
    def continuous_action_logit_bias(self, penalty: float = -1e10) -> np.ndarray:
        bias = np.zeros((self.padded_vocab_size,), dtype=np.float32)
        bias[: self.continuous_offset] = penalty
        bias[self.separator_id:] = penalty
        return bias

    def discrete_action_logit_bias(
        self, num_actions: int, penalty: float = -1e10
    ) -> np.ndarray:
        bias = np.full((self.padded_vocab_size,), penalty, dtype=np.float32)
        lo = self.discrete_offset
        bias[lo: lo + num_actions] = 0.0
        return bias
