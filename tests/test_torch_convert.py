"""The port's DeepSpeed export and convert CLI
(bdm_db1_tpu_torch/train/convert.py ``save_deepspeed_checkpoint``,
``main``) against the JAX package's, on the CPU at db1_tiny in f32. The
JAX params are the JAX model's tree with every leaf drawn from a numpy
seed; the port holds them through ``load_jax_params``. Held bitwise (no
tolerance: both sides cast the same f32 values to the same dtype): the
port's file against JAX's for the same params (with and without the
vision tower, tied and untied head, ``untie_r`` on and off, fp16 and
f32); JAX's ``convert_checkpoint`` of the port's file; a float32 round
trip; the CLI on a JAX-written file, read back by ``load_params``; the
export of a tp 2 and of a pp 2 model; the int8 refusal.

JAX is imported inside the tests: the worlds' processes import this
module for :func:`export_rank` and start without it."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from bdm_db1_tpu_torch.core import config as tcfg
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
from bdm_db1_tpu_torch.models.vision import VisionEmbedding
from bdm_db1_tpu_torch.train import convert as tconv
from tests import torch_dist_workers as tw

TAG = "db1_tiny_checkpoint"
N_VISION = 14       # the vision tower's tensors


@functools.lru_cache(maxsize=None)
def _jax_params(vision: bool, tied: bool = True, untie_r: bool = False,
                seed: int = 0):
    """(JAX config, params as numpy): the param tree of JAX's db1_tiny with
    these choices (``vision``: initialised on an image-RL batch, so the
    tree has the vision subtree), each leaf N(0, 0.5) from a numpy
    ``RandomState(seed)`` in the tree's order."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from bdm_db1_tpu.core.config import db1_tiny
    from bdm_db1_tpu.data.input_specs import RLTaskBatch
    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JTXL

    cfg = db1_tiny()
    cfg.model.dtype = "float32"
    cfg.model.share_input_output_embedding = tied
    cfg.model.untie_r = untie_r
    tok = jnp.zeros((1, cfg.model.n_position), jnp.int32)
    images = None
    if vision:
        tok = tok.at[0, 0].set(-1)
        hw = 2 * cfg.vision.patch_size
        images = jnp.zeros((1, 1, hw, hw, 3), jnp.float32)
    batch = RLTaskBatch(tokens=tok, position_id=jnp.abs(tok),
                        loss_mask=jnp.abs(tok), label=jnp.abs(tok),
                        images=images)
    model = JTXL(cfg.model, cfg.vocab, cfg.vision)
    shapes = nn.meta.unbox(jax.eval_shape(
        model.init, jax.random.PRNGKey(0), {"rl": batch})["params"])
    assert ("vision" in shapes) == vision
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda s: (0.5 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)
    return cfg, params


def _pcfg(**overrides):
    return tcfg.db1_tiny(dtype="float32", **overrides)


def _port(pnp, **overrides):
    """The port's db1_tiny holding the JAX params (vision tower at its
    seeded init when the tree has none)."""
    cfg = _pcfg(**overrides)
    model = TransformerXL(cfg.model, cfg.vocab, device="cpu",
                          generator=torch.Generator().manual_seed(7))
    tconv.load_jax_params(model, pnp)
    return cfg, model


def _module(path):
    obj = torch.load(path, map_location="cpu", weights_only=True)
    assert list(obj) == ["module"]
    return obj["module"]


def _logits(model, seed=0):
    """f32 logits [B, L, V] of a seeded RL batch through ``forward``."""
    from bdm_db1_tpu_torch.data.input_specs import RLTaskBatch

    rng = np.random.RandomState(seed)
    n = model.layout.total_vocab_size
    tok = torch.from_numpy(rng.randint(0, n, (2, 16)))
    pos = torch.from_numpy(rng.randint(0, 8, (2, 16)))
    with torch.no_grad():
        return model({"rl": RLTaskBatch(tokens=tok, position_id=pos)},
                     compute_loss=False)[0]


# ---- (a) the port's file against JAX's ---------------------------------------

@pytest.mark.parametrize("dtype", ["float16", "float32"])
@pytest.mark.parametrize("untie_r", [False, True], ids=["tied_r", "untie_r"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied_head", "lm_head"])
@pytest.mark.parametrize("vision", [True, False], ids=["vision", "no_vision"])
def test_export_matches_jax(vision, tied, untie_r, dtype, tmp_path):
    """The same names, shapes, dtypes and bits as JAX's file; the port's
    model always holds the vision tower, so for a tree without one the
    port's file has its 14 tensors besides (the port's init, cast)."""
    from bdm_db1_tpu.train.convert import save_deepspeed_checkpoint as jsave

    jcfg, pnp = _jax_params(vision, tied, untie_r)
    pcfg, model = _port(pnp, share_input_output_embedding=tied,
                        untie_r=untie_r)
    want = _module(jsave(pnp, jcfg, str(tmp_path / "jax"), TAG, dtype))
    path = tconv.save_deepspeed_checkpoint(
        model, pcfg, str(tmp_path / "port"), TAG, dtype)
    assert path == str(tmp_path / "port" / TAG / tconv.MODEL_STATES)
    got = _module(path)
    vis = {k for k in got if k.startswith(tconv.VISION_PREFIX)}
    assert len(vis) == N_VISION and (vis <= set(want)) == vision
    assert set(got) == set(want) | vis
    assert ("lm_head.weight" in got) == (not tied)
    assert ("r_w_bias" in got) == (not untie_r)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert got[k].device.type == "cpu", k
        assert torch.equal(got[k], v), k
    sd = model.state_dict()
    for k in vis - set(want):
        assert torch.equal(got[k], sd[k].to(getattr(torch, dtype))), k


# ---- (b) JAX reads the port's file -------------------------------------------

@pytest.mark.parametrize("tied", [True, False], ids=["tied_head", "lm_head"])
def test_jax_converter_reads_the_export(tied, tmp_path):
    """JAX's ``convert_checkpoint`` of the port's fp16 file: the JAX params
    rounded to fp16, the padded vocab rows (and head columns) zero."""
    import jax

    from bdm_db1_tpu.train.convert import convert_checkpoint

    jcfg, pnp = _jax_params(True, tied)
    pcfg, model = _port(pnp, share_input_output_embedding=tied)
    tconv.save_deepspeed_checkpoint(model, pcfg, str(tmp_path), TAG)
    got = convert_checkpoint(str(tmp_path), TAG, jcfg)
    want = jax.tree.map(lambda x: x.astype(np.float16).astype(np.float32),
                        pnp)
    total = jcfg.vocab.layout().total_vocab_size
    want["word_embedding"]["embedding"][total:] = 0.0
    if not tied:
        want["lm_head"]["kernel"][:, total:] = 0.0
    assert (jax.tree.structure(got) == jax.tree.structure(want))
    for (path, g), w in zip(jax.tree.leaves_with_path(got),
                            jax.tree.leaves(want)):
        assert g.dtype == np.float32, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


# ---- (c) a float32 round trip ------------------------------------------------

def test_float32_round_trip(tmp_path):
    """A port model out as float32 and back in through
    ``load_deepspeed_checkpoint``: every tensor bitwise, except the padded
    vocab rows, which the file does not hold and come back zero, and the
    positional buffer, which comes back as the converters compute it (no
    forward reads it); the logits over the real vocab bitwise."""
    cfg = _pcfg()
    src = TransformerXL(cfg.model, cfg.vocab, device="cpu",
                        generator=torch.Generator().manual_seed(5))
    path = tconv.save_deepspeed_checkpoint(src, cfg, str(tmp_path), TAG,
                                           "float32")
    dst = TransformerXL(cfg.model, cfg.vocab, device="cpu",
                        generator=torch.Generator().manual_seed(6))
    assert tconv.load_deepspeed_checkpoint(dst, path) == []
    total = cfg.vocab.layout().total_vocab_size
    a, b = src.state_dict(), dst.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        if k == "word_embedding.weight":
            assert torch.equal(b[k][:total], a[k][:total])
            assert not b[k][total:].any() and a[k][total:].any()
        elif k == "pos_emb.inv_freq":
            assert torch.equal(b[k], torch.from_numpy(
                tconv._inv_freq(cfg.model.n_embed)))
        else:
            assert torch.equal(b[k], a[k]), k
    la, lb = _logits(src), _logits(dst)
    assert torch.equal(lb[..., :total], la[..., :total])


# ---- (d) the CLI -------------------------------------------------------------

@pytest.mark.parametrize("vision", [False, True], ids=["no_vision", "vision"])
def test_cli_writes_a_port_checkpoint(vision, tmp_path, capsys):
    """``main`` on a file written by JAX's function: one step, 0, with the
    client state; ``load_params`` reads it as the port's checkpoint, to
    the logits of the file read straight through
    ``load_deepspeed_checkpoint``; a file without the vision tower gets
    the tower at its seeded init."""
    from bdm_db1_tpu.train.convert import convert_checkpoint
    from bdm_db1_tpu.train.convert import save_deepspeed_checkpoint as jsave
    from bdm_db1_tpu_torch.eval import evaluate_rl as ter
    from bdm_db1_tpu_torch.train.checkpoint import CheckpointManager

    jcfg, pnp = _jax_params(vision)
    ds, out = str(tmp_path / "ds"), str(tmp_path / "port")
    file = jsave(pnp, jcfg, ds, TAG)
    cfg = _pcfg()
    cfg.eval.seed = 3
    cfg.to_json(str(tmp_path / "cfg.json"))
    capsys.readouterr()
    tconv.main(["--load-dir", ds, "--tag", TAG, "--output", out,
                "--config", str(tmp_path / "cfg.json")])
    lines = capsys.readouterr().out.splitlines()
    import jax
    n = sum(v.size for v in jax.tree.leaves(convert_checkpoint(ds, TAG,
                                                               jcfg)))
    assert lines[-2:] == [f"converted {n:,} parameters",
                          f"wrote port checkpoint to {out}/0"]
    assert ("no vision tower" in lines[0]) == (not vision)
    assert CheckpointManager(out).all_steps() == [0]
    with open(os.path.join(out, "0", "client.json")) as f:
        assert json.load(f) == {"source": f"{ds}/{TAG}", "iteration": 0}

    cfg.train.load_dir = out
    models = [TransformerXL(cfg.model, cfg.vocab, device="cpu",
                            generator=torch.Generator().manual_seed(s))
              for s in (1, 2)]
    assert ter.load_params(cfg, models[0]) == ter.FROM_PORT
    left = tconv.load_deepspeed_checkpoint(models[1], file)
    assert len(left) == (0 if vision else N_VISION)
    a, b = (m.state_dict() for m in models)
    for k in a:
        if k not in left:
            assert torch.equal(a[k], b[k]), k
    if left:
        tower = VisionEmbedding(cfg.model, cfg.vision, "cpu", torch.float32)
        tower.reset_parameters(torch.Generator().manual_seed(3))
        init = tower.state_dict()
        for k in left:
            assert torch.equal(a[k], init[k[len(tconv.VISION_PREFIX):]]), k
    assert torch.equal(_logits(models[0]), _logits(models[1]))


def test_cli_help_runs_without_a_card():
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "bdm_db1_tpu_torch.train.convert", "--help"],
        cwd=root, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr
    assert "--load-dir" in res.stdout and "--output" in res.stdout


# ---- (e) a sharded model's export --------------------------------------------

def export_rank(rank, world, state_dict, mesh_kw, out_dir):
    """A rank of a tp 2 or pp 2 world: the model from ``state_dict``, then
    its export; returns (the path, whether the file was there on
    return)."""
    if mesh_kw.get("pipeline_parallel", 1) > 1:
        tp, pp = tw.pp_of(mesh_kw)
        model = tw.pp_model(state_dict, tp, pp)
    else:
        model = tw.tp_model(state_dict, tw.tp_of(mesh_kw))
    path = tconv.save_deepspeed_checkpoint(model, _pcfg(), out_dir, TAG)
    return path, os.path.exists(path)


MESHES = {"tp2": {"model_parallel": 2},
          "pp2": {"data_parallel": 1, "pipeline_parallel": 2,
                  "model_parallel": 1, "pipeline_microbatches": -1}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, started together, from one random port model; and that
    model's one-process export."""
    tmp = tmp_path_factory.mktemp("convert_worlds")
    cfg = _pcfg()
    model = TransformerXL(cfg.model, cfg.vocab, device="cpu",
                          generator=torch.Generator().manual_seed(11))
    sd = model.state_dict()
    out = {name: (str(tmp / name), tw.World(export_rank, 2, tmp, sd, kw,
                                            str(tmp / name)))
           for name, kw in MESHES.items()}
    out["one"] = tconv.save_deepspeed_checkpoint(model, cfg,
                                                 str(tmp / "one"), TAG)
    yield out
    for name in MESHES:
        try:
            out[name][1].join()
        except Exception:
            pass


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_export_matches_one_process(mesh, worlds):
    out_dir, world = worlds[mesh]
    want = os.path.join(out_dir, TAG, tconv.MODEL_STATES)
    assert world.join() == [(want, True)] * 2
    got, ref = _module(want), _module(worlds["one"])
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype == torch.float16, k
        assert torch.equal(got[k], ref[k]), k


# ---- (f) the refusal ---------------------------------------------------------

@pytest.mark.parametrize("weights", ["int8", "int8a8"])
def test_int8_weights_are_refused(weights, tmp_path):
    cfg = _pcfg(decode_weight_dtype=weights)
    model = TransformerXL(cfg.model, cfg.vocab, device="cpu")
    with pytest.raises(ValueError, match="decode_weight_dtype"):
        tconv.save_deepspeed_checkpoint(model, cfg, str(tmp_path), TAG)
    assert not os.path.exists(tmp_path / TAG)
