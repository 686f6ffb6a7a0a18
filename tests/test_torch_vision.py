"""The port's vision tower and image groups against the JAX package's, on
the CPU at db1_tiny in f32: ``VisionEmbedding`` at eval, the training
patch positions, ``DropPath``, the logits of a mixed {rl, rl_img, ic,
vqa} batch, one deterministic loss-and-gradient step (vision leaves
included) and the weight-decay mask on the vision names."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.core.config import db1_tiny
from bdm_db1_tpu.data.input_specs import ICTaskBatch as JIC
from bdm_db1_tpu.data.input_specs import RLTaskBatch as JRL
from bdm_db1_tpu.data.input_specs import VQATaskBatch as JVQA
from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
from bdm_db1_tpu.models.vision import VisionEmbedding as JVision
from bdm_db1_tpu.train import step as jstep
from bdm_db1_tpu_torch.core import config as tcfg
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL as PortTXL
from bdm_db1_tpu_torch.models.utils import DropPath
from bdm_db1_tpu_torch.train.convert import load_jax_params, state_dict_from_jax
from bdm_db1_tpu_torch.train.step import decay_mask
from bdm_db1_tpu_torch.train.trainer import to_gato_batch
from tests.torch_port_helpers import one_thread, to_numpy

# VisionEmbedding at eval: max |port - JAX| at most VISION_TOL * max |JAX|.
# f32 on both sides; the GroupNorm variance is E[x^2] - E[x]^2 in flax and
# two-pass in torch, a few ulps apart.
VISION_TOL = 1e-5
# the mixed batch's logits (the bar of tests/test_parity.py): max |port -
# JAX| at most LOGIT_TOL * max |JAX|
LOGIT_TOL = 2e-4
# loss within LOSS_RTOL, each gradient leaf within GRAD_RTOL of its largest
# value (tests/test_torch_train_step.py's bars)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SEQ = 64
HW = 32            # 2 x 2 patches of 16
_NO_DROP = dict(drop=0.0, embd_pdrop=0.0, dropattn=0.0)


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _jax_cfg():
    cfg = db1_tiny()
    cfg.model.dtype = "float32"
    for k, v in _NO_DROP.items():
        setattr(cfg.model, k, v)
    return cfg


def _mixed_numpy(seed: int = 0, accum: int = 1):
    """{rl, ic, vqa, rl_img} with [accum, rows, ...] fields: an RL row
    without images, two image-RL rows whose -1 slots take 3 frames of 2 x
    2 patches (one slot run cut short by the sequence end), and one
    captioning and one VQA row of [prompt 3 | 4 patches | text 57]."""
    rng = np.random.RandomState(seed)
    a = accum

    def ints(hi, *shape):
        return rng.randint(0, hi, (a,) + shape)

    def mask(*shape):
        return (rng.rand(a, *shape) < 0.5).astype(np.float32)

    img_tok = ints(321, 2, SEQ)
    for t in range(3):                       # [4 slots | 4 tokens] x 3 ...
        img_tok[..., 8 * t:8 * t + 4] = -1
    img_tok[..., 60:] = -1                   # ... and a cut run at the end
    text = SEQ - 3 - 4
    return {
        "rl": {"tokens": ints(321, 1, SEQ), "position_id": ints(60, 1, SEQ),
               "loss_mask": mask(1, SEQ), "label": ints(321, 1, SEQ)},
        "rl_img": {"tokens": img_tok, "position_id": ints(60, 2, SEQ),
                   "loss_mask": mask(2, SEQ), "label": ints(321, 2, SEQ),
                   "images": rng.rand(a, 2, 4, HW, HW, 3).astype(np.float32)},
        "ic": {"prompt": ints(256, 1, 3),
               "images": rng.rand(a, 1, HW, HW, 3).astype(np.float32),
               "text": ints(256, 1, text), "loss_mask": mask(1, SEQ),
               "label": ints(256, 1, SEQ)},
        "vqa": {"prompt": ints(256, 1, 3),
                "images": rng.rand(a, 1, HW, HW, 3).astype(np.float32),
                "text": ints(256, 1, text), "ques_len": np.full((a, 1), 5),
                "loss_mask": mask(1, SEQ), "label": ints(256, 1, SEQ)},
    }


_JAX_TYPES = {"rl": JRL, "rl_img": JRL, "ic": JIC, "vqa": JVQA}


def _jax_batch(nb, a=0):
    return {m: _JAX_TYPES[m](**{k: jnp.asarray(v[a]) for k, v in f.items()})
            for m, f in nb.items()}


@functools.lru_cache(maxsize=None)
def _jax_model():
    """db1_tiny with the vision subtree: (cfg, model, params, numpy)."""
    cfg = _jax_cfg()
    model = JaxTXL(cfg.model, cfg.vocab, cfg.vision)
    params = jax.jit(model.init)(jax.random.PRNGKey(3),
                                 _jax_batch(_mixed_numpy()))["params"]
    return cfg, model, params, to_numpy(params)


def _port(pnp):
    pcfg = tcfg.db1_tiny(dtype="float32", **_NO_DROP)
    model = PortTXL(pcfg.model, pcfg.vocab, vision=pcfg.vision, device="cpu")
    assert load_jax_params(model, pnp) == []
    return model


def test_vision_embedding_eval_matches_jax():
    """A non-square batch (2 x 3 patches): the per-patch convolutions,
    the normalisation and the midpoint positions."""
    cfg, _, _, pnp = _jax_model()
    pixels = np.random.RandomState(1).rand(3, 32, 48, 3).astype(np.float32)
    jv = JVision(cfg.model, cfg.vision)
    want = np.asarray(jv.apply({"params": _jax_model()[2]["vision"]},
                               jnp.asarray(pixels), deterministic=True))
    port = _port(pnp)
    with torch.no_grad():
        got = port.vision_encoder(torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape == (3, 6, cfg.model.n_embed)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=VISION_TOL * np.abs(want).max())


def test_patch_positions_in_their_intervals():
    """Training positions: each id inside its patch's [low, high), the
    midpoint at eval, and another generator seed draws other ids."""
    pcfg = tcfg.db1_tiny(dtype="float32")
    model = PortTXL(pcfg.model, pcfg.vocab, device="cpu")
    enc = model.vision_encoder
    pv = pcfg.vision.position_vocab_size
    h0, w0 = 5, 7
    seq = np.arange(h0 * w0)
    lo_r, hi_r = (seq // w0) * pv // h0, (seq // w0 + 1) * pv // h0
    lo_c, hi_c = (seq % w0) * pv // w0, (seq % w0 + 1) * pv // w0
    draws = []
    for seed in (0, 1):
        r, c = enc.position_ids(64, h0, w0, False,
                                torch.Generator().manual_seed(seed), "cpu")
        r, c = r.numpy(), c.numpy()
        assert ((r >= lo_r) & (r < hi_r)).all()
        assert ((c >= lo_c) & (c < hi_c)).all()
        draws.append((r, c))
    assert not np.array_equal(draws[0][0], draws[1][0])
    assert not np.array_equal(draws[0][1], draws[1][1])
    r, c = enc.position_ids(2, h0, w0, True, None, "cpu")
    np.testing.assert_array_equal(r.numpy()[0], (lo_r + hi_r) // 2)
    np.testing.assert_array_equal(c.numpy()[1], (lo_c + hi_c) // 2)


def test_drop_path_keep_rate_and_scale():
    rate = 0.3
    x = torch.ones(20000, 3, 2)
    y = DropPath(rate)(x, deterministic=False,
                       generator=torch.Generator().manual_seed(0))
    kept = (y[:, 0, 0] != 0).float()
    # one flag a sample: a row is all kept or all dropped
    assert torch.equal((y != 0).all(dim=(1, 2)).float(), kept)
    assert abs(float(kept.mean()) - (1 - rate)) < 0.015
    assert torch.allclose(y[kept.bool()], torch.tensor(1 / (1 - rate)))
    assert DropPath(rate)(x) is x                 # eval: the identity


def test_mixed_image_batch_logits_match_jax():
    """Rows in [rl || ic || vqa || rl_img] order, the image slots spliced
    from the frames, the captioning/VQA rows without the timestep term."""
    cfg, model, params, pnp = _jax_model()
    nb = _mixed_numpy(seed=5)
    want, _ = jax.jit(lambda p, b: model.apply(
        {"params": p}, b, compute_loss=False))(params, _jax_batch(nb))
    want = np.asarray(want)
    port = _port(pnp)
    micro = {m: {k: v[0] for k, v in f.items()} for m, f in nb.items()}
    with torch.no_grad():
        got, _ = port(to_gato_batch(micro, "cpu"), compute_loss=False)
    assert got.shape == want.shape == (5, SEQ, want.shape[-1])
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def test_mixed_image_batch_gradients_match_jax():
    """The loss and every gradient leaf of one deterministic step (eval
    patch positions, dropout 0) through the JAX loss function and the
    port's forward; the vision leaves are among them."""
    cfg, model, params, pnp = _jax_model()
    nb = _mixed_numpy(seed=7)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.apply({"params": p}, b, deterministic=True,
                                 loss_only=True)[1]))(params, _jax_batch(nb))
    j_sd, _ = state_dict_from_jax(to_numpy(j_grads), tcfg.db1_tiny())
    port = _port(pnp)
    micro = {m: {k: v[0] for k, v in f.items()} for m, f in nb.items()}
    named = list(port.named_parameters())
    _, loss = port(to_gato_batch(micro, "cpu"), deterministic=True,
                   loss_only=True)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    assert abs(float(loss.detach()) - float(j_loss)) <= LOSS_RTOL * abs(float(j_loss))
    vision = [n for n, _ in named if n.startswith("vision_encoder.")]
    assert len(vision) == 14
    for (name, _), g in zip(named, grads):
        ref = j_sd[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=name)


def test_decay_mask_on_the_vision_names():
    """The conv kernels and position tables decay, the GroupNorm scales
    and the biases do not: JAX's ``_decay_mask`` of the vision subtree."""
    _, _, params, pnp = _jax_model()
    jmask = jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                         jstep._decay_mask(pnp), pnp)
    want, _ = state_dict_from_jax(jmask, tcfg.db1_tiny())
    got = decay_mask(_port(pnp))
    vision = {n for n in got if n.startswith("vision_encoder.")}
    assert len(vision) == 14
    for name in vision:
        assert got[name] == bool(want[name].flatten()[0]), name
    assert sum(got[n] for n in vision) == 6   # 4 kernels, 2 tables


def test_checkpoint_without_the_vision_tower_names_it(tmp_path):
    """A port checkpoint whose model has no vision tensors (written before
    the tower existed): restoring it raises and names the missing keys."""
    import torch.distributed.checkpoint as dcp

    from bdm_db1_tpu_torch.train.checkpoint import (
        CheckpointManager, load_model, state_tensors,
    )
    from bdm_db1_tpu_torch.train.step import init_train_state

    pcfg = tcfg.db1_tiny(dtype="float32")
    model = PortTXL(pcfg.model, pcfg.vocab, device="cpu")
    state = init_train_state(model, pcfg.train.optimizer, 2)
    old = state_tensors(state)
    old["model"] = {k: v for k, v in old["model"].items()
                    if not k.startswith("vision_encoder.")}
    old["optimizer"] = {k: ({n: t for n, t in v.items()
                             if not n.startswith("vision_encoder.")}
                            if isinstance(v, dict) else v)
                        for k, v in old["optimizer"].items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # dcp without a process group
        dcp.save(old, checkpoint_id=str(tmp_path / "run" / "4"))
    mgr = CheckpointManager(str(tmp_path / "run"))
    with pytest.raises(ValueError, match="vision_encoder.patch_embeddings"):
        mgr.restore(state)
    with pytest.raises(ValueError, match="14 model names"):
        load_model(model, mgr.step_dir(4))
