"""Pipeline parallelism in the port (parallel/pipeline.py), on the CPU at
db1_tiny(n_layer=4) in f32 without dropout, in gloo worlds
(tests/torch_dist_workers.py), against the JAX package's
``pipeline_trunk`` and its pipelined ``make_sharded_train_step`` on the
virtual CPU devices, and against the one-process port: the GPipe forward
at (pp, tp, n_micro) = (2, 1, 2), (2, 2, 4) and (4, 1, 2); two steps at
(dp, pp, tp) = (2, 2, 1) and (1, 2, 2); each stage's layers; a pipeline
checkpoint restored in one process; ``pretrain.main`` at pp 2; the
dropout masks (one dropped r on every stage, no mask drawn twice, the
one-process trunk's output distribution) and a run with dropout that
learns; the refusals."""

import contextlib
import dataclasses
import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.core.config import MeshConfig as JMesh
from bdm_db1_tpu.core.config import OptimizerConfig as JOpt
from bdm_db1_tpu.core.config import db1_tiny as jdb1_tiny
from bdm_db1_tpu.data.input_specs import RLTaskBatch as JBatch
from bdm_db1_tpu.models.transformer_xl import TransformerXL as JTXL
from bdm_db1_tpu.parallel.mesh import make_mesh as jmake_mesh
from bdm_db1_tpu.parallel.pipeline import pipeline_trunk as jpipeline_trunk
from bdm_db1_tpu.train import step as jstep
from bdm_db1_tpu_torch.core import config as tcfg
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
from bdm_db1_tpu_torch.parallel import mesh as tmesh
from bdm_db1_tpu_torch.train.convert import state_dict_from_jax
from tests import torch_dist_workers as tw
from tests.torch_port_helpers import (
    jax_tiny, one_thread, port_model, to_numpy,
)

N_LAYER = 4
_NO_DROP = dict(drop=0.0, embd_pdrop=0.0, dropattn=0.0)
_OVER = dict(n_layer=N_LAYER, **_NO_DROP)
OPT = dict(lr=1e-3)
STEPS = 2
# tests/test_pipeline.py's trunk bar, and the train-step bars of
# tests/test_torch_train_step.py (tests/test_torch_tensor_parallel.py)
TRUNK_ATOL = 2e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_RTOL = 2e-3
PARAM_ATOL = 2 * STEPS * OPT["lr"]
# the trunk cases (pp, tp, n_micro) and the step meshes (dp, pp, tp) with
# their pipeline micro-batches; the first two trunk cases run in the
# step worlds
TRUNKS = [(2, 1, 2), (2, 2, 4), (4, 1, 2)]
STEP_MESHES = {(2, 2, 1): 2, (1, 2, 2): 4}
# tests/test_pipeline.py's dropout distribution test: draws and bar
SAMPLES = 96
SE_BAR = 5


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _batch():
    """An RL loader batch [accum 2, micro 4, 64] of db1_tiny's vocab, rows
    with unequal loss-mask densities."""
    return tw.numpy_batch(2, 4, 64, seed=13, densities=(0.2, 0.3, 0.7, 0.8))


def _const_batch():
    """tests/test_pipeline.py's learnable batch: 8 text rows of one token
    each, every position in the loss."""
    rng = np.random.RandomState(0)
    toks = rng.randint(1, 256, (1, 8, 64)).astype(np.int32)
    toks[..., :] = toks[..., :1]
    return {"nlp": {"tokens": toks, "loss_mask": np.ones(toks.shape,
                                                         np.float32),
                    "label": toks}}


@functools.lru_cache(maxsize=None)
def _jax_init():
    """JAX db1_tiny(n_layer=4) in f32 without dropout: (cfg, model,
    params as numpy, the port's state dict of them)."""
    cfg = jdb1_tiny(n_layer=N_LAYER)
    cfg.model.dtype = "float32"
    for k, v in _NO_DROP.items():
        setattr(cfg.model, k, v)
    cfg.model.resid_pdrop = 0.0
    cfg.model.attention_impl = "xla"
    model = JTXL(cfg.model, cfg.vocab, cfg.vision)
    tok = jnp.zeros((1, cfg.model.n_position), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), {"rl": JBatch(
        tokens=tok, position_id=tok, loss_mask=tok, label=tok)})["params"]
    pnp = to_numpy(params)
    sd, _ = state_dict_from_jax(pnp, tcfg.db1_tiny(n_layer=N_LAYER))
    return cfg, model, pnp, sd


def _jax_batch(raw):
    return {"rl": JBatch(**{k: jnp.asarray(v) for k, v in raw["rl"].items()})}


@functools.lru_cache(maxsize=None)
def _jax_trunk(pp: int, tp: int, n_micro: int):
    """JAX's ``pipeline_trunk`` over the first micro-batch on a (1, pp, tp)
    mesh, and its single-stage trunk."""
    cfg, model, pnp, _ = _jax_init()
    params = jax.tree.map(jnp.asarray, pnp)
    micro = jax.tree.map(lambda x: x[0], _jax_batch(_batch()))
    h, _, _ = model.apply({"params": params}, micro, True,
                          method=JTXL.embed_concat, with_targets=False)
    ref, _ = model.apply({"params": params}, h, None, True,
                         method=JTXL.trunk)
    mesh = jmake_mesh(JMesh(data_parallel=1, pipeline_parallel=pp,
                            model_parallel=tp),
                      devices=jax.devices()[:pp * tp])
    out = jpipeline_trunk(cfg.model, params["layers"], params.get("r_w_bias"),
                          params.get("r_r_bias"), h, n_micro, mesh,
                          deterministic=True)
    return np.asarray(out), np.asarray(ref)


@functools.lru_cache(maxsize=None)
def _jax_step(dp: int, pp: int, tp: int, n_micro: int):
    """JAX's pipelined ``make_sharded_train_step`` on a (dp, pp, tp) mesh:
    the loss of each of STEPS steps and the parameters after, as the
    port's names; the first step's gradients (jax.grad of the loss,
    averaged over the micro-batches) and their global norm."""
    cfg, model, pnp, _ = _jax_init()
    params = jax.tree.map(jnp.asarray, pnp)
    tx = jstep.make_optimizer(JOpt(**OPT), 20)
    jbatch = _jax_batch(_batch())
    mesh = jmake_mesh(JMesh(data_parallel=dp, pipeline_parallel=pp,
                            model_parallel=tp),
                      devices=jax.devices()[:dp * pp * tp])
    _, step_fn = jstep.make_sharded_train_step(
        model, tx, jax.random.PRNGKey(0), jbatch, mesh,
        pipeline_microbatches=n_micro)
    gfn = jax.jit(jax.grad(jstep.make_loss_fn(model)))
    g = [gfn(params, jax.tree.map(lambda x: x[a], jbatch),
             jax.random.PRNGKey(0)) for a in range(2)]
    grads = jax.tree.map(lambda a, b: np.asarray((a + b) / 2), *g)
    norm = float(np.sqrt(sum(np.sum(np.square(x))
                             for x in jax.tree.leaves(grads))))
    pcfg = tcfg.db1_tiny(n_layer=N_LAYER)
    grads, _ = state_dict_from_jax(grads, pcfg)
    state = jstep.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                             opt_state=tx.init(params))
    losses = []
    for _ in range(STEPS):
        state, met = step_fn(state, jbatch, jax.random.PRNGKey(1))
        losses.append(float(met["loss"]))
    after, _ = state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                                   pcfg)
    return dict(losses=losses, after=after, grads=grads, grad_norm=norm)


def _mesh_kw(dp, pp, tp, n_micro=-1):
    return {"data_parallel": dp, "pipeline_parallel": pp,
            "model_parallel": tp, "pipeline_microbatches": n_micro}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds, started together before the JAX side is computed: the
    two step meshes (each with its trunk case), the pp 4 trunk, the
    dropout world and pretrain.main at pp 2."""
    from tests.test_torch_data_parallel import _pretrain_cfg

    tmp = tmp_path_factory.mktemp("pp")
    sd = _jax_init()[3]
    out = dict(tmp=tmp, sd=sd)
    for (dp, pp, tp), n in STEP_MESHES.items():
        ckpt = str(tmp / f"ckpt_{dp}{pp}{tp}")
        out[("step", dp, pp, tp)] = ckpt, tw.World(
            tw.pp_step, dp * pp * tp, tmp, sd, _batch(), OPT, _OVER,
            _mesh_kw(dp, pp, tp, n), STEPS, ckpt)
    out["trunk4"] = tw.World(tw.pp_step, 4, tmp, sd, _batch(), OPT, _OVER,
                             _mesh_kw(1, 4, 1, TRUNKS[-1][2]), 0, None)
    sd2 = port_model(jax_tiny()[3]).state_dict()
    out["dropout"] = tw.World(tw.pp_dropout, 2, tmp, sd2, _batch(),
                              _const_batch(), SAMPLES, _mesh_kw(1, 2, 1))
    cfg = _pretrain_cfg(tmp)
    cfg.mesh.pipeline_parallel = 2
    # the stages draw masks of their own: compared without dropout
    cfg.model = dataclasses.replace(cfg.model, **_NO_DROP)
    out["pretrain_cfg"] = cfg
    out["pretrain"] = tw.World(tw.pretrain_main, 2, tmp, cfg)
    out["eval"] = _eval_world(tmp)
    yield out
    for w in out.values():
        if isinstance(w, tuple):
            w = w[1]
        if isinstance(w, tw.World):
            try:
                w.join()
            except RuntimeError:
                pass                # reported by the test that joined it


def _eval_world(tmp):
    """tests/test_torch_sharded_decode.py's ``evaluate_rl.main`` (three
    envs, lockstep, 2 trials) with ``eval.sharded_decode`` on a mesh with a
    pipe axis, pp 2: (the one-process config, the world)."""
    from bdm_db1_tpu_torch.eval import envs as te
    from tests.test_torch_data_parallel import ENV_B, _eval_setup

    _, cfg = _eval_setup(tmp)
    cfg.eval = dataclasses.replace(cfg.eval, batched=True, num_trials=2,
                                   batch_size=2)
    piped = dataclasses.replace(
        cfg, eval=dataclasses.replace(cfg.eval, sharded_decode=True),
        mesh=dataclasses.replace(cfg.mesh, pipeline_parallel=2),
        train=dataclasses.replace(cfg.train, save_dir=str(tmp / "piped")))
    world = tw.World(tw.evaluate_rl_main, 2, tmp, piped,
                     {"fake-continuous-b-v0": ENV_B})
    te.register_env("fake-continuous-b-v0",
                    lambda: te.FakeContinuousEnv(**ENV_B))
    return cfg, world


def _step_ranks(worlds, mesh):
    ckpt, world = worlds[("step",) + mesh]
    return ckpt, world.join()


@functools.lru_cache(maxsize=None)
def _one_process_steps():
    """The one-process port model of the same weights: its trunk over the
    first micro-batch, its STEPS steps' losses and its parameters
    after."""
    from bdm_db1_tpu_torch.core.config import OptimizerConfig
    from bdm_db1_tpu_torch.train import step as tstep
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    model = tw.tp_model(_jax_init()[3], None, **_OVER)
    with torch.no_grad():
        h = model.embed_concat(to_gato_batch(tw._first_micro(_batch()),
                                             "cpu"), with_targets=False)[0]
        trunk = model.trunk(h, None)[0]
    state = tstep.init_train_state(model, OptimizerConfig(**OPT), 20)
    step = tstep.make_train_step(model)
    batch = to_gato_batch(_batch(), "cpu")
    losses = []
    for _ in range(STEPS):
        state, met = step(state, batch, torch.Generator())
        losses.append(float(met["loss"]))
    return dict(losses=losses, trunk=trunk, params={
        n: p.detach().clone() for n, p in model.named_parameters()})


def _merged(ranks, key):
    out = {}
    for r in ranks:
        out.update(r[key])
    return out


# ---- the GPipe forward -----------------------------------------------------

@pytest.mark.parametrize("pp,tp,n_micro", TRUNKS)
def test_pipeline_trunk_matches_jax_and_one_process(worlds, pp, tp,
                                                    n_micro):
    """The last stage's output of ``pipeline_trunk`` (every rank of it,
    each data rank) within TRUNK_ATOL of JAX's ``pipeline_trunk`` on a
    (1, pp, tp) mesh, of JAX's single-stage trunk and of the one-process
    port trunk; the other stages return None."""
    if (pp, tp) == (4, 1):
        ranks = worlds["trunk4"].join()
    else:
        mesh = next(m for m in STEP_MESHES if m[1:] == (pp, tp))
        assert STEP_MESHES[mesh] == n_micro   # the world's micro-batches
        ranks = _step_ranks(worlds, mesh)[1]
    want, ref = _jax_trunk(pp, tp, n_micro)
    one = _one_process_steps()["trunk"].numpy()
    np.testing.assert_allclose(want, ref, rtol=0, atol=TRUNK_ATOL)
    last = [r for r in ranks if r["stage"] == pp - 1]
    assert len(last) == len(ranks) // pp
    assert all(r["trunk"] is None for r in ranks if r["stage"] != pp - 1)
    for r in last:
        got = r["trunk"].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TRUNK_ATOL)
        np.testing.assert_allclose(got, one, rtol=0, atol=TRUNK_ATOL)


def test_stages_hold_their_layers(worlds):
    """Rank r sits at (d, s, t) with r = (d pp + s) tp + t, and stage s of
    pp holds layers [s n / pp, (s + 1) n / pp) under their global
    names."""
    for (dp, pp, tp) in STEP_MESHES:
        ranks = _step_ranks(worlds, (dp, pp, tp))[1]
        coords = [(d, s, t) for d in range(dp) for s in range(pp)
                  for t in range(tp)]
        assert [tuple(r["coords"]) for r in ranks] == coords
        for r in ranks:
            n = N_LAYER // pp
            assert r["layers"] == list(range(r["stage"] * n,
                                             (r["stage"] + 1) * n))
    assert [r["layers"] for r in worlds["trunk4"].join()] == [
        [0], [1], [2], [3]]


@pytest.mark.parametrize("world", [*STEP_MESHES, "trunk4"], ids=str)
def test_gather_stages_puts_whole_model_on_stage_0(worlds, world):
    """``gather_stages`` gives stage 0 the whole model (each model rank its
    shards), every tensor of the one-process model bit for bit with its
    one shared r_w_bias/r_r_bias pair, and the later stages None."""
    ranks = (worlds["trunk4"].join() if world == "trunk4"
             else _step_ranks(worlds, world)[1])
    one = tw.tp_model(_jax_init()[3], None, **_OVER)
    want = one.state_dict()
    firsts = [r for r in ranks if r["stage"] == 0]
    assert firsts and all(r["gathered"] is None for r in ranks
                          if r["stage"] != 0)
    for r in firsts:
        assert r["gathered_params"] == len(list(one.parameters()))
        assert r["gathered"].keys() == want.keys()
        for n, t in want.items():
            assert torch.equal(r["gathered"][n], t), n


# ---- the train step ---------------------------------------------------------

@pytest.mark.parametrize("mesh", list(STEP_MESHES), ids=str)
def test_pipelined_step_matches_jax_and_one_process(worlds, mesh):
    """Two steps at (dp, pp, tp): every rank's losses within LOSS_RTOL of
    JAX's pipelined step on the same mesh and of the one-process port
    step; the parameters after, put together from the stages, within the
    update bars of JAX's."""
    want = _jax_step(*mesh, STEP_MESHES[mesh])
    one = _one_process_steps()
    ranks = _step_ranks(worlds, mesh)[1]
    for r in ranks:
        got = [loss for loss, _ in r["losses"]]
        np.testing.assert_allclose(got, want["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, one["losses"], rtol=LOSS_RTOL)
    params = _merged(ranks, "params")
    before = _jax_init()[3]
    assert params.keys() == one["params"].keys()
    moved = 0
    for n, p in params.items():
        if n.startswith("vision_encoder."):
            continue
        dg, dj = p - before[n], want["after"][n] - before[n]
        assert float(dj.norm()) > 0, n
        assert float((dg - dj).abs().max()) <= PARAM_ATOL, n
        assert float((dg - dj).norm()) <= UPDATE_RTOL * float(dj.norm()), n
        moved += 1
    assert moved > 10


@pytest.mark.parametrize("mesh", list(STEP_MESHES), ids=str)
def test_pipelined_gradients_match_jax(worlds, mesh):
    """The first step's gradients the optimizer was handed, put together
    from the stages (the replicated ones summed over the pipe group: the
    tied table's of stage 0's embedding and the last stage's head), within
    GRAD_RTOL of JAX's; the global norm counts each stage's layers and
    each replicated leaf once."""
    want = _jax_step(*mesh, STEP_MESHES[mesh])
    ranks = _step_ranks(worlds, mesh)[1]
    for r in ranks:
        assert abs(r["losses"][0][1] - want["grad_norm"]) <= (
            1e-5 * want["grad_norm"])
    grads = _merged(ranks, "grads")
    assert len(grads) > 10
    for name, g in grads.items():
        ref = want["grads"][name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=name)
    for r in ranks:   # each stage's replicated gradients, whole
        for name in ("word_embedding.weight", "r_w_bias", "r_r_bias"):
            if name in r["grads"]:
                torch.testing.assert_close(r["grads"][name], grads[name],
                                           rtol=0, atol=0)


@pytest.mark.parametrize("mesh", list(STEP_MESHES), ids=str)
def test_pipeline_checkpoint_restores_in_one_process(worlds, mesh):
    """The step's collective checkpoint holds whole tensors, each stage's
    layers under their global names: ``load_model`` in this one process
    reads the stages' parameters bit for bit."""
    from bdm_db1_tpu_torch.train.checkpoint import load_model

    ckpt, ranks = _step_ranks(worlds, mesh)
    cfg = tcfg.db1_tiny(dtype="float32", **_OVER)
    model = TransformerXL(cfg.model, cfg.vocab, device="cpu")
    load_model(model, os.path.join(ckpt, str(STEPS)))
    want = _merged(ranks, "params")
    for n, p in model.named_parameters():
        assert torch.equal(p, want[n]), n


# ---- pretrain.main ------------------------------------------------------------

def test_pp_pretrain_main_matches_one_process(worlds, tmp_path):
    """``pretrain.main`` with ``mesh.pipeline_parallel`` 2 in a world of
    two (one layer a stage, no dropout): rank 0 logs the three steps and the eval
    hook (the validation loss through the stages, a rollout on the
    gathered model), the step-3 checkpoint holds whole tensors; the
    losses are those of ``pretrain.main`` in one process and the
    rollout's records equal."""
    from bdm_db1_tpu_torch.train import pretrain
    from bdm_db1_tpu_torch.train.checkpoint import load_model

    out0, out1 = worlds["pretrain"].join()
    assert "2 processes" in out0 and out1 == ""
    cfg = worlds["pretrain_cfg"]
    run = cfg.train.save_dir

    def records(path):
        return [json.loads(line) for line in
                open(os.path.join(path, "metrics.jsonl")).read().splitlines()]

    one = dataclasses.replace(cfg, mesh=tcfg.MeshConfig(),
                              train=dataclasses.replace(
                                  cfg.train, save_dir=str(tmp_path / "one")))
    with contextlib.redirect_stdout(io.StringIO()):
        pretrain.main(one, device="cpu")
    got, want = records(run), records(one.train.save_dir)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert any("valid/loss" in r for r in got)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k.startswith(("train/loss", "valid/loss")):
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                           err_msg=k)
            elif k.startswith(("valid/return", "valid/length")):
                assert g[k] == w[k], k
    model = TransformerXL(cfg.model, cfg.vocab, device="cpu")
    load_model(model, os.path.join(run, "3"))
    ref = TransformerXL(cfg.model, cfg.vocab, device="cpu")
    load_model(ref, os.path.join(one.train.save_dir, "3"))
    for (n, p), (_, q) in zip(model.named_parameters(),
                              ref.named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-5, msg=n)


def test_evaluate_rl_on_a_pipe_mesh_matches_one_process(worlds):
    """``evaluate_rl.main`` with ``eval.sharded_decode`` and
    ``mesh.pipeline_parallel`` 2: the decode keeps the one-process path
    (JAX's pipeline trains only), the two stages' ranks evaluate the same
    data shard, and the records hold one copy of it, equal to the
    one-process driver's."""
    from bdm_db1_tpu_torch.eval import evaluate_rl as ter

    cfg, world = worlds["eval"]
    with contextlib.redirect_stdout(io.StringIO()):
        want = ter.main(cfg, device="cpu")
    ranks = world.join()
    assert [r["env"] for r in want[:-1]] == list(cfg.eval.env_names)
    assert ranks[0]["records"] == want
    assert ranks[1]["records"] == want[:-1]     # rank 0 sums the suite up


# ---- dropout --------------------------------------------------------------------

def test_pipeline_stages_use_one_dropped_r(worlds):
    """Stage 0 draws the embedding dropout of r on the whole batch and
    every stage attends with that one r (JAX's pipeline drops r once,
    before the stages)."""
    a, b = worlds["dropout"].join()
    torch.testing.assert_close(a["r"], b["r"], rtol=0, atol=0)
    assert float((a["r"] == 0).float().mean()) > 0.05


def test_pipeline_dropout_masks_unique(worlds):
    """No two (stage, layer, micro-batch, site) draws of one pipelined step
    give the same mask (the port's counterpart of
    tests/test_pipeline.py's collision-free key map): two stages of two
    layers, four pipeline micro-batches, the o_net and FF sites."""
    ranks = worlds["dropout"].join()
    masks = [m for r in ranks for m in r["masks"]]
    assert len(masks) == 2 * 2 * 4 * 2
    assert len(set(masks)) == len(masks)


def test_pipeline_dropout_distribution_matches_trunk(worlds):
    """tests/test_pipeline.py's statistical check on the port: over
    SAMPLES draws the pipelined trunk's per-element means agree with the
    one-process trunk's within SE_BAR standard errors of the difference
    (no embedding dropout), draws vary, and the global moments line
    up."""
    a, b = worlds["dropout"].join()
    pipe = b["pipe_samples"].numpy()
    trunk = a["trunk_samples"].numpy()
    assert pipe.shape == trunk.shape and pipe.shape[0] == SAMPLES
    assert pipe.std(axis=0).max() > 0
    assert not np.allclose(pipe[0], pipe[1])
    p_mean, t_mean = pipe.mean(0), trunk.mean(0)
    se = np.sqrt((pipe.var(0) + trunk.var(0)) / SAMPLES)
    diff = np.abs(p_mean - t_mean)
    assert (diff <= SE_BAR * se + 1e-4).mean() > 0.995, (
        diff.max(), (SE_BAR * se + 1e-4).max())
    np.testing.assert_allclose(p_mean.mean(), t_mean.mean(), atol=2e-3)
    np.testing.assert_allclose(pipe.std(), trunk.std(), rtol=0.05)


def test_pipeline_with_dropout_runs_and_learns(worlds):
    """Six steps with dropout 0.1 at every site on a learnable batch at pp
    2: finite losses, equal on both stages, that fall below 0.8 of the
    first; the replicated parameters end bitwise equal on both stages."""
    a, b = worlds["dropout"].join()
    assert a["losses"] == b["losses"]
    assert np.isfinite(a["losses"]).all()
    assert a["losses"][-1] < a["losses"][0] * 0.8, a["losses"]
    assert a["replicated"].keys() == b["replicated"].keys()
    for n, p in a["replicated"].items():
        assert torch.equal(p, b["replicated"][n]), n


# ---- the stage model and the refusals -----------------------------------------

@pytest.mark.parametrize("stage,size", [(0, 2), (1, 2), (3, 4)])
def test_stage_init_is_the_one_process_share(stage, size):
    """A stage's seeded init is the one-process init's share, bit for bit,
    under the one-process names (no process group needed)."""
    cfg = tcfg.db1_tiny(dtype="float32", n_layer=N_LAYER)
    one = TransformerXL(cfg.model, cfg.vocab, device="cpu",
                        generator=torch.Generator().manual_seed(5))
    pp = tmesh.PipelineParallel(stage=stage, size=size)
    part = TransformerXL(cfg.model, cfg.vocab, device="cpu",
                         generator=torch.Generator().manual_seed(5), pp=pp)
    want = tmesh.stage_state_dict(one.state_dict(), pp, N_LAYER)
    got = part.state_dict()
    assert got.keys() == want.keys()
    for n, t in got.items():
        assert torch.equal(t, want[n]), n
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    with pytest.raises(ValueError, match="pipeline stage"):
        part(to_gato_batch(tw._first_micro(_batch()), "cpu"))


def test_pipeline_parallel_must_divide_the_layers():
    """Three stages cannot split four layers: ``ValueError`` naming
    ``n_layer`` (the JAX ``pipeline_trunk`` asserts it)."""
    cfg = tcfg.db1_tiny(dtype="float32", n_layer=N_LAYER)
    with pytest.raises(ValueError, match="n_layer"):
        TransformerXL(cfg.model, cfg.vocab, device="cpu",
                      pp=tmesh.PipelineParallel(stage=0, size=3))
    with pytest.raises(ValueError, match="n_layer"):
        tmesh.stage_layers(N_LAYER, 0, 3)
    assert tmesh.stage_layers(24, 1, 2) == range(12, 24)
