"""Mu-law continuous scalar tokenizer (Gato scheme), the numpy path of
bdm_db1_tpu/tokenizers/scalar.py.

Observations are mu-law companded ``sign(x)·log(|x|·mu+1)/log(mu·M+1)`` and
clamped to [-1, 1] before linear binning; actions skip the companding in
both directions.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScalarTokenizer:
    num_continuous_bin: int = 1024
    mu: float = 100.0
    M: float = 256.0

    def discretize_np(self, x: np.ndarray, is_action: bool) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        if not is_action:
            x = np.sign(x) * np.log(np.abs(x) * self.mu + 1.0) / np.log(
                np.float32(self.mu * self.M + 1.0)
            )
            x = np.clip(x, -1.0, 1.0)
        # trunc-toward-zero then clip matches floor-then-clip on [0, n) and
        # both collapse negatives to bin 0
        bins = ((x + 1.0) / 2.0 * self.num_continuous_bin).astype(np.int32)
        return np.clip(bins, 0, self.num_continuous_bin - 1)

    def decode_np(self, bins: np.ndarray, is_action: bool) -> np.ndarray:
        bins = np.clip(np.asarray(bins), 0, self.num_continuous_bin - 1)
        x = (bins.astype(np.float32) / self.num_continuous_bin) * 2.0 - 1.0
        if not is_action:
            x = np.sign(x) * ((1.0 + self.M * self.mu) ** np.abs(x) - 1.0) / self.mu
        return x
