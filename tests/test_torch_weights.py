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
    init = {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith("vision_encoder.")}
    # the tree was initialised on RL batches: no vision subtree, so the
    # port's tower keeps its init and the loader names it
    assert load_jax_params(model, pnp) == sorted(init) and len(init) == 14
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in init.items())
    np.testing.assert_array_equal(
        sd["h.1.dec_attn.qkv_net.weight"].numpy(),
        pnp["layers"]["attn"]["qkv_net"]["kernel"][1].T)
    # one shared (r_w_bias, r_r_bias) pair, listed under every layer
    assert model.h[0].dec_attn.r_w_bias is model.r_w_bias
    np.testing.assert_array_equal(sd["h.0.dec_attn.r_r_bias"].numpy(),
                                  pnp["r_r_bias"])


def test_vision_leaves_are_skipped_by_name():
    """A tree with the vision tower (initialised on an image-RL batch): no
    leaf is skipped; the state dict has invert_state_dict's names and
    values (conv kernels HWIO -> OIHW); it loads with strict=True; and the
    port's state dict goes back through the JAX package's
    ``convert_state_dict`` to the same leaves."""
    from bdm_db1_tpu.core.config import db1_tiny
    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
    from bdm_db1_tpu.train.convert import convert_state_dict

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
    assert "vision" in pnp
    pcfg = port_config.db1_tiny(dtype="float32")
    ref = invert_state_dict(params, cfg)
    sd, skipped = state_dict_from_jax(pnp, pcfg)
    assert skipped == [] and set(sd) == set(ref)
    for name in (k for k in ref if k.startswith("vision_encoder.")):
        np.testing.assert_array_equal(sd[name].numpy(), ref[name],
                                      err_msg=name)
    model = TransformerXL(pcfg.model, pcfg.vocab, device="cpu")
    model.load_state_dict(sd, strict=True)
    assert load_jax_params(model, pnp) == []
    back = {k: v.numpy() for k, v in model.state_dict().items()}
    total = cfg.vocab.layout().total_vocab_size
    back["word_embedding.weight"] = back["word_embedding.weight"][:total]
    again = to_numpy(convert_state_dict(back, cfg))
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat(pnp["vision"]))
    got = dict(flat(again["vision"]))
    assert got.keys() == want.keys() and len(want) == 14
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


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
