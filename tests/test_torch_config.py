"""The port's config copy (bdm_db1_tpu_torch/core/config.py) against the JAX
package's: every field of each section with the same default, and the two
named configs equal section for section."""

import dataclasses

import pytest

from bdm_db1_tpu.core import config as jc
from bdm_db1_tpu_torch.core import config as tc


def _fields(cls):
    return {f.name: (f.default, f.default_factory)
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["VocabConfig", "VisionConfig",
                                  "ModelConfig", "DataConfig", "EvalConfig"])
def test_section_fields_match_jax(name):
    assert _fields(getattr(tc, name)) == _fields(getattr(jc, name))


@pytest.mark.parametrize("name", ["db1_tiny", "db1_1p2b"])
def test_named_configs_match_jax(name):
    j, t = getattr(jc, name)(), getattr(tc, name)()
    for section in ("model", "vocab", "vision", "data", "eval"):
        assert dataclasses.asdict(getattr(t, section)) == \
            dataclasses.asdict(getattr(j, section)), section
    tl, jl = t.vocab.layout(), j.vocab.layout()
    for attr in ("discrete_offset", "continuous_offset", "separator_id",
                 "total_vocab_size", "padded_vocab_size"):
        assert getattr(tl, attr) == getattr(jl, attr), attr
    assert t.model.d_head == j.model.d_head
    assert t.model.d_inner == j.model.d_inner
