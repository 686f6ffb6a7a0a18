"""The port's attention index helpers, positional embedding and activations
against the JAX package's, on the same numpy inputs: masks and shifts
exactly, floating results within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.models import activations as ja_act
from bdm_db1_tpu.ops import attention as ja
from bdm_db1_tpu.ops import positional as jp
from bdm_db1_tpu_torch.models import activations as ta_act
from bdm_db1_tpu_torch.ops import attention as ta
from bdm_db1_tpu_torch.ops import positional as tp


@pytest.mark.parametrize("klen,d,clamp", [(40, 64, 64), (1025, 128, 30)])
def test_relative_positional_embedding(klen, d, clamp):
    ref = np.asarray(jp.relative_positional_embedding(klen, d, clamp))
    got = tp.relative_positional_embedding(klen, d, clamp).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shift", ["rel_shift", "rel_shift_sliced"])
@pytest.mark.parametrize("q,k", [(1, 33), (5, 37), (19, 51)])
def test_rel_shifts(shift, q, k):
    x = np.random.RandomState(q * k).randn(2, 3, q, k).astype(np.float32)
    ref = np.asarray(getattr(ja, shift)(jnp.asarray(x)))
    got = getattr(ta, shift)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_sliced_shift_equals_full_shift_on_valid_columns():
    q, k = 7, 40
    x = torch.from_numpy(
        np.random.RandomState(1).randn(1, 2, q, k).astype(np.float32))
    full, sliced = ta.rel_shift(x), ta.rel_shift_sliced(x)
    valid = ~ta.causal_mask(q, k)
    np.testing.assert_array_equal(full[..., valid].numpy(),
                                  sliced[..., valid].numpy())


@pytest.mark.parametrize("q,k,mem", [(1, 33, 32), (19, 51, 32), (32, 64, 32),
                                     (5, 5, 32)])
def test_masks(q, k, mem):
    np.testing.assert_array_equal(ta.causal_mask(q, k).numpy(),
                                  np.asarray(ja.causal_mask(q, k)))
    np.testing.assert_array_equal(ta.same_length_mask(q, k, mem).numpy(),
                                  np.asarray(ja.same_length_mask(q, k, mem)))


def test_same_length_bans_oldest_column_at_q1():
    m = ta.same_length_mask(1, 33, 32)
    assert bool(m[0, 0]) and not bool(m[0, 1:].any())


@pytest.mark.parametrize("name", ["gelu", "geglu", "gelu_new"])
def test_activations(name):
    x = np.random.RandomState(2).randn(3, 5, 16).astype(np.float32) * 2
    ref = np.asarray(ja_act.ACT2FN[name](jnp.asarray(x)))
    got = ta_act.ACT2FN[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
