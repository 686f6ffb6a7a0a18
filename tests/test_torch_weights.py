"""The weight bridge (bdm_db1_tpu_torch/train/convert.py): JAX params ->
the port's state dict, held against the JAX package's own
``invert_state_dict`` names and values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.data.input_specs import RLTaskBatch
from bdm_db1_tpu.train.convert import invert_state_dict
from bdm_db1_tpu_torch.core import config as port_config
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
from bdm_db1_tpu_torch.train.convert import load_jax_params, state_dict_from_jax
from torch_port_helpers import jax_tiny, to_numpy


@pytest.fixture(scope="module")
def tiny():
    return jax_tiny("off")


def test_names_and_values_match_invert_state_dict(tiny):
    cfg, _, params, pnp = tiny
    ref = invert_state_dict(params, cfg)
    sd, skipped = state_dict_from_jax(pnp, port_config.db1_tiny())
    assert skipped == []
    assert set(sd) == set(ref)
    total = cfg.vocab.layout().total_vocab_size
    for name, val in ref.items():
        got = sd[name].numpy()
        if name == "word_embedding.weight":
            # the port's table keeps the padded vocab rows
            assert got.shape[0] == cfg.vocab.layout().padded_vocab_size
            np.testing.assert_array_equal(
                got[total:], np.asarray(pnp["word_embedding"]["embedding"])[total:])
            got = got[:total]
        np.testing.assert_array_equal(got, val, err_msg=name)


def test_load_strict_and_read_back(tiny):
    _, _, _, pnp = tiny
    pcfg = port_config.db1_tiny(dtype="float32")
    model = TransformerXL(pcfg.model, pcfg.vocab, device="cpu")
    assert load_jax_params(model, pnp) == []
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["h.1.dec_attn.qkv_net.weight"].numpy(),
        pnp["layers"]["attn"]["qkv_net"]["kernel"][1].T)
    # one shared (r_w_bias, r_r_bias) pair, listed under every layer
    assert model.h[0].dec_attn.r_w_bias is model.r_w_bias
    np.testing.assert_array_equal(sd["h.0.dec_attn.r_r_bias"].numpy(),
                                  pnp["r_r_bias"])


def test_vision_leaves_are_skipped_by_name():
    """A tree with the vision tower: every vision leaf is named as skipped,
    every other leaf is consumed, and the load stays strict."""
    from bdm_db1_tpu.core.config import db1_tiny
    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL

    cfg = db1_tiny()
    cfg.model.dtype = "float32"
    jm = JaxTXL(cfg.model, cfg.vocab, cfg.vision)
    tok = jnp.zeros((1, cfg.model.n_position), jnp.int32).at[0, 0].set(-1)
    hw = 2 * cfg.vision.patch_size
    params = jm.init(jax.random.PRNGKey(1), {"rl": RLTaskBatch(
        tokens=tok, position_id=jnp.abs(tok), loss_mask=jnp.abs(tok),
        label=jnp.abs(tok),
        images=jnp.zeros((1, 1, hw, hw, 3), jnp.float32))})["params"]
    pnp = to_numpy(params)
    vision_leaves = ["vision/" + "/".join(str(k.key) for k in path)
                     for path, _ in jax.tree_util.tree_leaves_with_path(
                         pnp["vision"])]
    assert vision_leaves
    pcfg = port_config.db1_tiny(dtype="float32")
    model = TransformerXL(pcfg.model, pcfg.vocab, device="cpu")
    assert sorted(load_jax_params(model, pnp)) == sorted(vision_leaves)
    ref = invert_state_dict(params, cfg)
    sd, _ = state_dict_from_jax(pnp, pcfg)
    assert set(sd) == {k for k in ref if not k.startswith("vision_encoder.")}


def test_unknown_leaves_raise(tiny):
    _, _, _, pnp = tiny
    bad = dict(pnp, extra={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="extra/kernel"):
        state_dict_from_jax(bad, port_config.db1_tiny())


def test_entry_points_default_to_cuda():
    pcfg = port_config.db1_tiny(dtype="float32")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerXL(pcfg.model, pcfg.vocab)
