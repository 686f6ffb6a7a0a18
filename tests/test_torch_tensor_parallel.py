"""Tensor parallelism in the port, on the CPU at db1_tiny in f32, in gloo
worlds (tests/torch_dist_workers.py): two ranks at tp 2 and one world of
four at dp 2 x tp 2. The TP forward's logits and train step against the
JAX package's ``make_sharded_train_step`` on a (1, 2) mesh, the
sequence-sharded option on and off, and the (2, 2) step; the shard and
gather round trip; the vocab-parallel fused CE at a shard width that is
not a multiple of 128; the mixed Trainer loop at tp 2 with dropout on
(the replicated parameters bitwise equal across the ranks, the losses of
one process, a checkpoint that restores in one process and resumes);
``pretrain.main`` at tp 2 against one process; the divisibility
``ValueError``."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.core.config import MeshConfig as JMesh
from bdm_db1_tpu.core.config import OptimizerConfig as JOpt
from bdm_db1_tpu.data.input_specs import RLTaskBatch as JBatch
from bdm_db1_tpu.parallel.mesh import make_mesh as jmake_mesh
from bdm_db1_tpu.train import step as jstep
from bdm_db1_tpu_torch.core import config as tcfg
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
from bdm_db1_tpu_torch.parallel import mesh as tmesh
from bdm_db1_tpu_torch.train import step as tstep
from bdm_db1_tpu_torch.train.convert import state_dict_from_jax
from tests import torch_dist_workers as tw
from tests.torch_port_helpers import jax_tiny, one_thread, port_model

TP = 2
_NO_DROP = dict(drop=0.0, embd_pdrop=0.0, dropattn=0.0)
OPT = dict(lr=1e-3)
# against JAX, f32 on both sides (tests/test_torch_train_step.py's bars):
# the logits within LOGITS_ATOL (tests/test_parity.py), the loss within
# LOSS_RTOL, each gradient within GRAD_RTOL of its leaf's largest value,
# the update of every leaf within UPDATE_RTOL of its norm and PARAM_ATOL
# elementwise (Adam divides each gradient by its own size)
LOGITS_ATOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_RTOL = 2e-3
PARAM_ATOL = 2 * OPT["lr"]
# a checkpoint record's bytes beyond its tensor's (torch.save's zip
# headers, about 1.6 KB); a shard's every chunk is a record of its own
TP_RECORD_BYTES = 2048
# rows 0-1 to data rank 0, rows 2-3 to data rank 1 (the dp 2 world)
DENSITIES = (0.2, 0.3, 0.7, 0.8)


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _batch():
    return tw.numpy_batch(2, 4, 64, seed=13, densities=DENSITIES)


def _mixed_batch(seed: int = 3) -> dict:
    """An {rl, nlp} loader batch [accum 2, micro 2, 64] of db1_tiny's
    vocab (tests/test_trainer.py's mixed loop)."""
    raw = tw.numpy_batch(2, 2, 64, seed, (0.5, 0.5))
    rng = np.random.RandomState(seed + 1)
    shape = (2, 2, 64)
    raw["nlp"] = {"tokens": rng.randint(0, 256, shape).astype(np.int32),
                  "loss_mask": (rng.rand(*shape) < 0.9).astype(np.float32),
                  "label": rng.randint(0, 256, shape).astype(np.int32)}
    return raw


def _trainer_cfg(save_dir):
    """db1_tiny in f32 with its dropout on, lr 3e-3, 6 iterations, a save
    every 3."""
    cfg = tcfg.db1_tiny(dtype="float32")
    cfg.train = dataclasses.replace(
        cfg.train, train_iters=6, save_interval=3, log_interval=2,
        eval_interval=1 << 30, save_dir=save_dir,
        optimizer=dataclasses.replace(cfg.train.optimizer, lr=3e-3,
                                      lr_decay_style="constant"))
    return cfg


def _ce_inputs():
    """h [2, 8, 16], a padded vocab of 384 rows whose shards (192 at tp 2)
    are not multiples of 128, the valid vocab 300 (the tail on rank 1),
    labels below it and a mask."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 8, 16, generator=g)
    emb = torch.randn(384, 16, generator=g) * 0.5
    labels = torch.randint(0, 300, (2, 8), generator=g)
    mask = (torch.rand(2, 8, generator=g) < 0.7).float()
    return h, emb, labels, mask, 300


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds, started together before the JAX side is computed: the
    TP step with the sequence-sharded option off and on, the dp 2 x tp 2
    step, the vocab-parallel CE, the mixed Trainer loop and pretrain.main
    at tp 2, all from the same JAX init."""
    from tests.test_torch_data_parallel import _pretrain_cfg

    tmp = tmp_path_factory.mktemp("tp")
    _, _, _, pnp = jax_tiny()
    sd = port_model(pnp).state_dict()
    out = dict(tmp=tmp, pnp=pnp, sd=sd)
    for sp in (False, True):
        out[("step", sp)] = tw.World(tw.tp_step, TP, tmp, sd, _batch(), OPT,
                                     _NO_DROP, {"model_parallel": TP}, sp)
    out["step_dp"] = tw.World(tw.tp_step, 4, tmp, sd, _batch(), OPT,
                              _NO_DROP, {"data_parallel": 2,
                                         "model_parallel": TP}, False)
    out["ce"] = tw.World(tw.tp_ce, TP, tmp, *_ce_inputs(),
                         {"model_parallel": TP})
    out["trainer_dir"] = str(tmp / "trainer")
    out["trainer"] = tw.World(tw.tp_trainer, TP, tmp, sd, _mixed_batch(),
                              _trainer_cfg(out["trainer_dir"]),
                              {"model_parallel": TP})
    cfg = _pretrain_cfg(tmp)
    cfg.mesh.model_parallel = TP
    out["pretrain_cfg"] = cfg
    out["pretrain"] = tw.World(tw.pretrain_main, TP, tmp, cfg)
    yield out
    for key, w in out.items():
        if isinstance(w, tw.World):
            try:
                w.join()
            except RuntimeError:
                pass                # reported by the test that joined it


def _jax_batch(raw):
    return {"rl": JBatch(**{k: jnp.asarray(v) for k, v in raw["rl"].items()})}


@functools.lru_cache(maxsize=None)
def _jax_step(dp: int, sp: bool):
    """JAX on a (dp, 2) mesh of the virtual CPU devices: one sharded train
    step of the batch (the loss, the parameters after), the first
    micro-batch's logits and the step's gradients (jax.grad averaged over
    the two micro-batches), as the port's names."""
    raw = _batch()
    _, jmodel, _, pnp = jax_tiny(attention_impl="xla",
                                 sequence_sharded_activations=sp, **_NO_DROP)
    params = jax.tree.map(jnp.asarray, pnp)
    tx = jstep.make_optimizer(JOpt(**OPT), 20)
    jbatch = _jax_batch(raw)
    mesh = jmake_mesh(JMesh(data_parallel=dp, model_parallel=TP),
                      devices=jax.devices()[:dp * TP])
    _, step_fn = jstep.make_sharded_train_step(
        jmodel, tx, jax.random.PRNGKey(0), jbatch, mesh)
    # the forward and the gradients first: the step donates the params
    micro = [jax.tree.map(lambda x: x[a], jbatch) for a in range(2)]
    logits = np.asarray(jmodel.apply({"params": params}, micro[0])[0])
    gfn = jax.jit(jax.grad(jstep.make_loss_fn(jmodel)))
    g = [gfn(params, m, jax.random.PRNGKey(0)) for m in micro]
    grads = jax.tree.map(lambda a, b: np.asarray((a + b) / 2), *g)
    norm = float(np.sqrt(sum(np.sum(np.square(x))
                             for x in jax.tree.leaves(grads))))
    pcfg = tcfg.db1_tiny()
    grads, _ = state_dict_from_jax(grads, pcfg)
    state = jstep.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                             opt_state=tx.init(params))
    state, met = step_fn(state, jbatch, jax.random.PRNGKey(1))
    after, _ = state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                                   pcfg)
    return dict(loss=float(met["loss"]), after=after, logits=logits,
                grads=grads, grad_norm=norm)


def _updates(params, before):
    return {n: p - before[n] for n, p in params.items()
            if not n.startswith("vision_encoder.")}


def _check_updates(got_params, want_params, before):
    got, want = _updates(got_params, before), _updates(want_params, before)
    assert got.keys() <= want.keys() and len(got) > 10
    for n, dg in got.items():
        dj = want[n]
        assert float(dj.norm()) > 0, n
        assert float((dg - dj).abs().max()) <= PARAM_ATOL, n
        assert float((dg - dj).norm()) <= UPDATE_RTOL * float(dj.norm()), n


# ---- the placement helpers -------------------------------------------------

def test_shard_round_trip_is_bitwise():
    """Every rank's shard of a whole state dict, put back together, is the
    state dict bit for bit, at tp 2 and 4; rank t's qkv_net rows are its
    heads' q, k and v rows (not a contiguous third), its CoreNet.0 rows
    its part of the GEGLU value half and of the gate half."""
    _, _, _, pnp = jax_tiny()
    sd = port_model(pnp).state_dict()
    cfg = tcfg.db1_tiny().model
    d, n = cfg.n_embed, cfg.d_inner // 2
    for size in (2, 4):
        parts = [tmesh.shard_state_dict(sd, tmesh.TensorParallel(r, size),
                                        cfg) for r in range(size)]
        for name, t in sd.items():
            rule = tmesh.shard_rule(name, cfg)
            if rule is None:
                assert all(p[name] is t for p in parts), name
                continue
            assert torch.equal(tmesh.unshard_tensor(
                [p[name] for p in parts], *rule), t), name
        qkv = sd["h.0.dec_attn.qkv_net.weight"]
        wi = sd["h.0.pos_ff.CoreNet.0.weight"]
        for r in range(size):
            k, m = d // size, n // size
            want = torch.cat([qkv[j * d + r * k:j * d + (r + 1) * k]
                              for j in range(3)])
            assert torch.equal(parts[r]["h.0.dec_attn.qkv_net.weight"], want)
            want = torch.cat([wi[r * m:(r + 1) * m],
                              wi[n + r * m:n + (r + 1) * m]])
            assert torch.equal(parts[r]["h.0.pos_ff.CoreNet.0.weight"], want)


def test_shards_load_and_gather_back_bitwise(worlds):
    """In the world: each rank loads its shard of the whole state dict and
    ``gather_state_dict`` gives the whole state dict back, bit for bit."""
    for r in worlds[("step", False)].join():
        assert r["roundtrip"]


@pytest.mark.parametrize("size,over,field", [
    (3, {}, "n_head"),
    (4, {"n_inner": 12}, "d_inner / 2")])
def test_model_parallel_must_divide_the_model(size, over, field):
    """A rank cannot hold a fraction of a head, of the FF width or of the
    padded vocab: ``ValueError`` naming the field (the JAX decode falls
    back to its XLA ring branch there instead:
    tests/test_torch_sharded_decode.py)."""
    cfg = tcfg.db1_tiny(dtype="float32", **over)
    with pytest.raises(ValueError, match=field):
        TransformerXL(cfg.model, cfg.vocab, device="cpu",
                      tp=tmesh.TensorParallel(0, size))


def test_ring_cache_shapes_are_the_ranks_heads():
    cfg = tcfg.db1_tiny().model
    shapes = tmesh.ring_cache_shardings(cfg, 5, tmesh.TensorParallel(1, 2))
    assert shapes["k"] == (cfg.n_layer, 5, cfg.mem_len, 2, cfg.d_head)
    assert shapes["k_scale"] == (cfg.n_layer, 5, cfg.mem_len, 2)


# ---- the forward and the train step against JAX ----------------------------

@pytest.mark.parametrize("key", [("step", False), ("step", True), "step_dp"])
def test_tp_logits_match_jax(worlds, key):
    """Each rank's logits of its data shard's first micro-batch, gathered
    over the vocab, within LOGITS_ATOL of JAX's forward."""
    want = _jax_step(1, False)["logits"]
    for r in worlds[key].join():
        d, _ = r["coords"]
        n = r["logits"].shape[0]
        np.testing.assert_allclose(r["logits"].numpy(),
                                   want[d * n:(d + 1) * n], rtol=0,
                                   atol=LOGITS_ATOL)


@pytest.mark.parametrize("sp", [False, True])
def test_tp_step_matches_jax_sharded_step(worlds, sp):
    """tp 2 (sequence-sharded or not): every rank's loss within LOSS_RTOL
    of JAX's ``make_sharded_train_step`` on a (1, 2) mesh, the whole
    update within the update bars."""
    want = _jax_step(1, sp)
    ranks = worlds[("step", sp)].join()
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=LOSS_RTOL)
    _check_updates(ranks[0]["params"], want["after"], worlds["sd"])


@pytest.mark.parametrize("sp", [False, True])
def test_tp_gradients_match_jax(worlds, sp):
    """The gradients the optimizer was handed, gathered whole, within
    GRAD_RTOL of JAX's (the layers' LayerNorm and FF output bias
    gradients summed over the model group under the sequence-sharded
    option); the global norm counts each replicated leaf once."""
    want = _jax_step(1, sp)
    for r in worlds[("step", sp)].join():
        assert len(r["grads"]) > 10
        for name, g in r["grads"].items():
            ref = want["grads"][name].numpy()
            np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                       atol=GRAD_RTOL * np.abs(ref).max(),
                                       err_msg=name)
        assert abs(r["grad_norm"] - want["grad_norm"]) <= (
            1e-5 * want["grad_norm"])


def test_dp_tp_step_matches_jax_sharded_step(worlds):
    """A world of four at dp 2 x tp 2, rank r at (r // 2, r % 2): the
    ranks of a data group read their half of the rows, and every rank's
    loss and the update match JAX's step on a (2, 2) mesh."""
    want = _jax_step(2, False)
    ranks = worlds["step_dp"].join()
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=LOSS_RTOL)
    _check_updates(ranks[3]["params"], want["after"], worlds["sd"])


def test_vocab_parallel_ce_matches_the_fused_ce(worlds):
    """The vocab-parallel fused CE over shards of 192 rows (not a multiple
    of 128: blocks of gcd(192, 128) = 64 multiples, here the whole shard),
    the valid-vocab tail on rank 1: the loss, dh and the gathered dW
    those of the one-process fused CE."""
    from bdm_db1_tpu_torch.ops.fused_ce import (
        _pick_block, masked_cross_entropy_fused,
    )

    h, emb, labels, mask, valid = _ce_inputs()
    hh, ww = h.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    loss = masked_cross_entropy_fused(hh, ww, labels, mask, valid)
    loss.backward()
    assert _pick_block(192) == 192 and _pick_block(16576) == 2368
    assert _pick_block(33152) == 4736       # the whole vocab, as before
    for r in worlds["ce"].join():
        assert r["rows"] == 192
        np.testing.assert_allclose(r["loss"], float(loss.detach()), rtol=1e-6)
        torch.testing.assert_close(r["dh"], hh.grad, rtol=0, atol=1e-6)
        torch.testing.assert_close(r["dw"], ww.grad, rtol=0, atol=1e-6)


# ---- the Trainer, its checkpoint, pretrain.main ----------------------------

@pytest.fixture(scope="module")
def one_process_trainer(tmp_path_factory):
    """The mixed loop in this one process from the same weights."""
    from bdm_db1_tpu_torch.train.trainer import Trainer

    tmp = tmp_path_factory.mktemp("tp_one")
    _, _, _, pnp = jax_tiny()
    model = port_model(pnp)
    cfg = _trainer_cfg(str(tmp / "one"))
    state = tstep.init_train_state(model, cfg.train.optimizer,
                                   cfg.train.train_iters)
    step = tstep.make_train_step(model)
    losses = []

    def recording(st, batch, gen):
        st, met = step(st, batch, gen)
        losses.append(float(met["loss"]))
        return st, met

    trainer = Trainer(cfg, model, recording, state,
                      tw.FixedLoader(_mixed_batch()))
    trainer.train()
    return {"losses": losses, "generator": trainer.state.generator.get_state(),
            "dir": cfg.train.save_dir}


def test_tp_trainer_mixed_loop(worlds, one_process_trainer):
    """tests/test_trainer.py's mixed {nlp, rl} loop at tp 2 with dropout
    on: 6 steps, checkpoints at 3 and 6, a fresh Trainer resumes at 6;
    both ranks draw the same masks (the generator seeded by the data
    rank), so their losses and replicated parameters are equal bit for
    bit, and the losses are the one-process loop's."""
    a, b = worlds["trainer"].join()
    assert a["step"] == b["step"] == 6
    assert a["resumed_at"] == b["resumed_at"] == 6
    assert sorted(os.listdir(worlds["trainer_dir"])) == [
        "3", "6", "metrics.jsonl"]
    recs = [json.loads(line) for line in open(
        os.path.join(worlds["trainer_dir"], "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [2, 4, 6]
    assert a["losses"] == b["losses"]
    assert torch.equal(a["generator"], b["generator"])
    assert torch.equal(a["generator"], one_process_trainer["generator"])
    assert a["replicated"].keys() == b["replicated"].keys()
    assert len(a["replicated"]) > 10
    for n, p in a["replicated"].items():
        assert torch.equal(p, b["replicated"][n]), n
    np.testing.assert_allclose(a["losses"], one_process_trainer["losses"],
                               rtol=LOSS_RTOL)


def test_tp_checkpoint_restores_in_one_process(worlds):
    """The tp 2 step-6 checkpoint holds whole tensors: ``load_params`` in
    this one process reads the ranks' gathered final weights bit for
    bit."""
    from bdm_db1_tpu_torch.eval import evaluate_rl as ter

    ranks = worlds["trainer"].join()
    cfg = tcfg.db1_tiny(dtype="float32")
    cfg.train.load_dir = worlds["trainer_dir"]
    model = TransformerXL(cfg.model, cfg.vocab, device="cpu")
    assert ter.load_params(cfg, model) == ter.FROM_PORT
    want = ranks[0]["params"]
    for n, p in model.named_parameters():
        if n in want:
            assert torch.equal(p, want[n]), n


def test_tp_checkpoint_writes_each_rank_its_chunks(worlds,
                                                  one_process_trainer):
    """The tp 2 step-6 checkpoint is written in place: the checkpoint
    module gathered no tensor; every sharded parameter and moment is its
    ranks' chunks under the whole tensor's key (qkv_net 3 a rank, the GEGLU
    input 2), each in its rank's file at its rank's offset, half the
    tensor a rank; each file holds at least its rank's shards' bytes, and
    the two files the one-process run's step-6 bytes, and for each record
    beyond that run's at most ``TP_RECORD_BYTES`` more."""
    import math

    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import MetadataIndex

    ranks = worlds["trainer"].join()
    assert [r["checkpoint_gathers"] for r in ranks] == [0, 0]
    md = dcp.FileSystemReader(os.path.join(worlds["trainer_dir"], "6")
                              ).read_metadata()
    cfg = tcfg.db1_tiny().model
    groups_seen = set()
    for key, tmd in md.state_dict_metadata.items():
        prefix, _, name = key.partition(".")
        if prefix == "optimizer":
            prefix, _, name = key.partition(".")[2].partition(".")
        rule = (tmesh.shard_rule(name, cfg)
                if prefix in ("model", "mu", "nu") else None)
        if rule is None:
            assert len(getattr(tmd, "chunks", [None])) == 1, key
            continue
        dim, groups = rule
        groups_seen.add((name.split(".")[-2:][0], groups))
        assert len(tmd.chunks) == groups * TP, key
        width = tmd.size[dim] // (groups * TP)
        volume = [0] * TP
        for c in tmd.chunks:
            path = md.storage_data[MetadataIndex(key, c.offsets)].relative_path
            r = int(path.split("_")[2])
            assert c.sizes[dim] == width and c.offsets[dim] // width % TP == r
            volume[r] += math.prod(c.sizes)
        assert volume == [math.prod(tmd.size) // TP] * TP, key
    assert {("qkv_net", 3), ("0", 2), ("o_net", 1)} <= groups_seen
    one_dir = os.path.join(one_process_trainer["dir"], "6")
    one = os.path.getsize(os.path.join(one_dir, "__0_0.distcp"))
    extra = len(md.storage_data) - len(
        dcp.FileSystemReader(one_dir).read_metadata().storage_data)
    assert all(r["file_bytes"] >= r["shard_bytes"] > 0 for r in ranks)
    diff = sum(r["file_bytes"] for r in ranks) - one
    assert extra > 0 and 0 <= diff <= extra * TP_RECORD_BYTES, (
        [r["file_bytes"] for r in ranks], one, extra)


def test_tp_pretrain_main_matches_one_process(worlds, tmp_path):
    """``pretrain.main`` with ``mesh.model_parallel`` 2 in a world of two
    (dp 1): both ranks read the whole batch, rank 0 logs the three steps
    and the eval hook (validation loss, a rollout run by both ranks), the
    step-3 checkpoint holds whole tensors; the losses are those of
    ``pretrain.main`` in one process."""
    import contextlib
    import io

    from bdm_db1_tpu_torch.train import pretrain

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
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k.startswith(("train/loss", "valid/loss")):
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                           err_msg=k)
            elif k.startswith(("valid/return", "valid/length")):
                assert g[k] == w[k], k
    assert os.path.isdir(os.path.join(run, "3"))
