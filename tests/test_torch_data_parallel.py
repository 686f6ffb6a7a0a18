"""Data parallelism in the port, on the CPU at db1_tiny in f32, in worlds of
two processes (gloo; tests/torch_dist_workers.py): the train step against
the JAX package's ``make_sharded_train_step`` on a ``data_parallel=2``
mesh and against the port's one-process step on the whole batch, whose
halves have unequal loss-mask counts (so a mean of the ranks' means would
miss); the ranks' parameters and dropout streams; a two-rank ``Trainer``
resumed from its collective checkpoint, and that checkpoint read by
``evaluate_rl.load_params`` in one process; ``evaluate_rl.main`` over an
uneven shard of three envs against the JAX driver's records."""

import dataclasses
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
from bdm_db1_tpu_torch.eval import evaluate_rl as ter
from bdm_db1_tpu_torch.train.convert import state_dict_from_jax
from bdm_db1_tpu_torch.train.trainer import to_gato_batch
from tests import torch_dist_workers as tw
from tests.torch_port_helpers import jax_tiny, one_thread, port_model

WORLD = 2
_NO_DROP = dict(drop=0.0, embd_pdrop=0.0, dropattn=0.0)
OPT = dict(lr=1e-3)
# the JAX comparison, f32 on both sides (tests/test_torch_train_step.py's
# bars): the loss within LOSS_RTOL; the update of every leaf within
# UPDATE_RTOL of its norm and PARAM_ATOL elementwise (Adam divides each
# gradient by its own size, so an element whose gradient is near zero moves
# by up to lr either way whatever its f32 rounding)
LOSS_RTOL = 1e-5
UPDATE_RTOL = 2e-3
PARAM_ATOL = 2 * OPT["lr"]
# the port's one-process step on the whole batch: the same sums in another
# order (a micro-batch's rows on two ranks, then the two ranks' gradients):
# the loss and the grad norm within ONE_PROCESS_RTOL, each gradient within
# ONE_PROCESS_RTOL of its leaf's largest value
ONE_PROCESS_RTOL = 1e-6
# rows 0-1 go to rank 0, rows 2-3 to rank 1: unequal loss-mask counts
DENSITIES = (0.2, 0.3, 0.7, 0.8)


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _batch():
    return tw.numpy_batch(2, 4, 64, seed=11, densities=DENSITIES)


def _jax_batch(raw):
    return {"rl": JBatch(**{k: jnp.asarray(v) for k, v in raw["rl"].items()})}


def _trainer_cfg(save_dir, train_iters):
    """db1_tiny in f32 with its dropout on, lr 1e-3, a save every 2
    iterations; every part of a run is built for the whole run's 3
    iterations (the schedules depend on it)."""
    cfg = tcfg.db1_tiny(dtype="float32")
    cfg.train = dataclasses.replace(
        cfg.train, train_iters=train_iters, save_interval=2, log_interval=1,
        eval_interval=1 << 30, save_dir=save_dir,
        optimizer=dataclasses.replace(cfg.train.optimizer, lr=1e-3))
    return cfg


EVAL_ENVS = ("fake-continuous-v0", "fake-continuous-b-v0", "fake-discrete-v0")
ENV_B = dict(seed=5, episode_len=6)


def _eval_setup(tmp):
    """The three envs' caches (tests/test_drivers.py's), the JAX db1_tiny
    params as a DeepSpeed checkpoint, a baselines file: (JAX config, port
    config) of evaluate_rl.main, one episode loop an env."""
    from bdm_db1_tpu.core.config import db1_tiny as jdb1_tiny
    from bdm_db1_tpu.data import rl_dataset as jd
    from bdm_db1_tpu.eval import envs as je
    from bdm_db1_tpu.train.convert import save_deepspeed_checkpoint

    for name, env in (("fake-continuous-v0", je.FakeContinuousEnv(
            episode_len=8)), ("fake-continuous-b-v0",
                              je.FakeContinuousEnv(**ENV_B)),
            ("fake-discrete-v0", je.FakeDiscreteEnv(episode_len=7))):
        jd.TrajectoryStore.from_flat_dataset(env.make_dataset(5)).save_cache(
            str(tmp / "rl"), name)
    je.register_env("fake-continuous-b-v0",
                    lambda: je.FakeContinuousEnv(**ENV_B))
    jcfg_tiny, _, params, _ = jax_tiny()
    save_deepspeed_checkpoint(params, jcfg_tiny, str(tmp / "ckpt"), "tag")
    base = tmp / "baselines.json"
    base.write_text(json.dumps({n: {"random": -100.0, "expert": 0.0}
                                for n in EVAL_ENVS}))
    cfgs = []
    for mk, out in ((jdb1_tiny, "jax"), (tcfg.db1_tiny, "port")):
        cfg = mk()
        cfg.model.dtype = "float32"
        cfg.data.rl_dataset_cache_dir = str(tmp / "rl")
        cfg.data.seq_length = cfg.model.n_position
        cfg.train.load_dir, cfg.train.ckpt_tag = str(tmp / "ckpt"), "tag"
        cfg.train.save_dir = str(tmp / out)
        cfg.eval = dataclasses.replace(
            cfg.eval, env_names=EVAL_ENVS, num_trials=1, max_step_size=3,
            batched=False, decode_obs_buckets=False,
            baselines_path=str(base))
        cfgs.append(cfg)
    return cfgs


PRETRAIN_ENV = "fake-continuous-v0"


def _pretrain_cfg(tmp):
    """tests/test_torch_pretrain.py's pretrain.main run (db1_tiny in f32, a
    0.5 text / 0.5 RL mixture of a byte corpus and the fake-continuous-v0
    cache, 3 iterations, the eval hook and a save at the 3rd) at global
    batch 16 of micro-batches of 4: accum 2 on each of two ranks."""
    from bdm_db1_tpu_torch.data.indexed_dataset import make_builder
    from bdm_db1_tpu_torch.data.rl_dataset import TrajectoryStore
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv

    rng = np.random.RandomState(0)
    b = make_builder(str(tmp / "corpus"), vocab_size=256)
    for _ in range(30):
        b.add_document(rng.randint(1, 200, size=60))
    b.finalize()
    TrajectoryStore.from_flat_dataset(
        FakeContinuousEnv(episode_len=8).make_dataset(5)).save_cache(
        str(tmp / "pt_rl"), PRETRAIN_ENV)
    cfg = tcfg.db1_tiny(dtype="float32")
    cfg.data.rl_dataset_cache_dir = str(tmp / "pt_rl")
    cfg.data.seq_length = cfg.model.n_position
    cfg.data.num_workers = 1
    cfg.data.data_path = ("0.5", str(tmp / "corpus"), "nlp", "0.5",
                          PRETRAIN_ENV, "rl")
    t = cfg.train
    t.train_iters, t.global_batch_size, t.micro_batch_size = 3, 16, 4
    t.log_interval, t.eval_interval, t.eval_iters = 1, 3, 1
    t.save_interval, t.save_dir = 3, str(tmp / "pretrain")
    cfg.eval.env_names = (PRETRAIN_ENV,)
    cfg.eval.num_trials, cfg.eval.max_step_size = 1, 2
    return cfg


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The two-rank worlds, started together before the JAX package's side
    is computed: the DP step (dropout off), an uninterrupted 3-iteration
    Trainer (dropout on, checkpoints at 2 and 3), another that resumes
    from a copy of its step 2, one whose rank 1 fails, and
    evaluate_rl.main, all from the same JAX init; pretrain.main; and
    the mesh."""
    tmp = tmp_path_factory.mktemp("dp")
    _, _, _, pnp = jax_tiny()
    sd = port_model(pnp).state_dict()
    eval_cfgs = _eval_setup(tmp)
    whole = str(tmp / "whole")
    out = dict(tmp=tmp, pnp=pnp, sd=sd, eval_cfgs=eval_cfgs, whole=whole,
               train_raw=tw.numpy_batch(2, 4, 64, seed=5,
                                        densities=DENSITIES))
    out["dp"] = tw.World(tw.dp_step, WORLD, tmp, sd, _batch(), OPT, _NO_DROP)
    out["whole_run"] = tw.World(tw.trainer_run, WORLD, tmp, sd,
                                out["train_raw"], _trainer_cfg(whole, 3))
    # a fresh world that resumes from a copy of the whole run's step 2
    part = str(tmp / "part")
    out["resumed_run"] = tw.World(tw.trainer_run, WORLD, tmp, sd,
                                  out["train_raw"], _trainer_cfg(part, 3),
                                  os.path.join(whole, "2"))
    out["eval"] = tw.World(tw.evaluate_rl_main, WORLD, tmp, eval_cfgs[1],
                           {"fake-continuous-b-v0": ENV_B})
    out["pretrain_cfg"] = _pretrain_cfg(tmp)
    out["pretrain"] = tw.World(tw.pretrain_main, WORLD, tmp,
                               out["pretrain_cfg"])
    out["failing"] = str(tmp / "failing")
    out["failing_run"] = tw.World(tw.trainer_fails, WORLD, tmp, sd,
                                  out["train_raw"],
                                  _trainer_cfg(out["failing"], 3))
    out["mesh"] = tw.World(tw.mesh_groups, WORLD, tmp, {})
    yield out
    for key in ("dp", "whole_run", "resumed_run", "eval", "pretrain",
                "failing_run", "mesh"):
        try:
            out[key].join()
        except RuntimeError:
            pass                # reported by the test that joined it


@pytest.fixture(scope="module")
def dp(worlds):
    """The two-rank step, JAX's sharded step on two devices and the port's
    one-process step on the same batch."""
    raw = _batch()
    _, jmodel, _, _ = jax_tiny(attention_impl="xla", **_NO_DROP)
    params = jax.tree.map(jnp.asarray, worlds["pnp"])
    tx = jstep.make_optimizer(JOpt(**OPT), 20)
    jbatch = _jax_batch(raw)
    mesh = jmake_mesh(JMesh(data_parallel=WORLD), devices=jax.devices()[:WORLD])
    _, step_fn = jstep.make_sharded_train_step(
        jmodel, tx, jax.random.PRNGKey(0), jbatch, mesh)
    state = jstep.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                             opt_state=tx.init(params))
    state, met = step_fn(state, jbatch, jax.random.PRNGKey(1))
    jparams, _ = state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                                     tcfg.db1_tiny())
    model = port_model(worlds["pnp"], **_NO_DROP)
    one = tw.one_step(model, raw, OPT)
    return dict(raw=raw, before=worlds["sd"], jax_loss=float(met["loss"]),
                jax_params=jparams, ranks=worlds["dp"].join(), one=one,
                pnp=worlds["pnp"])


def _updates(params, before):
    return {n: p - before[n] for n, p in params.items()
            if not n.startswith("vision_encoder.")}


def test_dp_loss_matches_jax_sharded_step(dp):
    for r in dp["ranks"]:
        np.testing.assert_allclose(r["loss"], dp["jax_loss"], rtol=LOSS_RTOL)


def test_dp_update_matches_jax_sharded_step(dp):
    got = _updates(dp["ranks"][0]["params"], dp["before"])
    want = _updates(dp["jax_params"], dp["before"])
    assert got.keys() <= want.keys() and len(got) > 10
    for n, dp_ in got.items():
        dj = want[n]
        assert float(dj.norm()) > 0, n
        assert float((dp_ - dj).abs().max()) <= PARAM_ATOL, n
        assert float((dp_ - dj).norm()) <= UPDATE_RTOL * float(dj.norm()), n


def test_mean_of_the_ranks_means_misses(dp):
    """The batch bites: its halves have unequal loss-mask counts in both
    micro-batches, and the mean of the two ranks' own masked means (DDP's
    loss) is further from JAX's loss than the DP bar."""
    raw = dp["raw"]
    model = port_model(dp["pnp"], **_NO_DROP)
    means = []
    with torch.no_grad():
        for r in range(WORLD):
            half = tw.shard(raw, r, WORLD)
            counts = half["rl"]["loss_mask"].sum(axis=(1, 2))
            means.append([])
            for a in range(2):
                sub = {"rl": {k: v[a] for k, v in half["rl"].items()}}
                _, loss = model(to_gato_batch(sub, "cpu"), loss_only=True)
                means[-1].append(float(loss))
            if r:
                assert (counts != prev).all(), (counts, prev)
            prev = counts
    mom = float(np.mean(means))
    assert abs(mom - dp["jax_loss"]) > 10 * LOSS_RTOL * abs(dp["jax_loss"])


def test_dp_step_matches_the_one_process_step(dp):
    one = dp["one"]
    for r in dp["ranks"]:
        np.testing.assert_allclose(r["loss"], one["loss"],
                                   rtol=ONE_PROCESS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], one["grad_norm"],
                                   rtol=ONE_PROCESS_RTOL)
        assert r["grads"].keys() == one["grads"].keys()
        for n, g in one["grads"].items():
            tol = ONE_PROCESS_RTOL * float(g.abs().max())
            assert float((r["grads"][n] - g).abs().max()) <= tol, n
    # the vision tower has no gradient on an RL batch, on every rank
    assert not any(n.startswith("vision_encoder.") for n in one["grads"])


def test_dp_ranks_hold_equal_parameters(dp):
    a, b = (r["params"] for r in dp["ranks"])
    assert a.keys() == b.keys()
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_dp_ranks_draw_their_own_dropout_masks(dp):
    """Each rank's training generator is seeded by (seed, rank): rank 0's
    is the one-process generator, rank 1's draws another mask."""
    from bdm_db1_tpu_torch.ops.fast_dropout import dropout
    from bdm_db1_tpu_torch.train.step import make_train_rng

    masks = [r["dropout_mask"] for r in dp["ranks"]]
    one = dropout(torch.ones(64, 64), 0.1, make_train_rng(0, "cpu")) != 0
    assert torch.equal(masks[0], one)
    assert not torch.equal(masks[0], masks[1])
    assert 0.8 < float(masks[1].float().mean()) < 1.0


@pytest.mark.parametrize("counts", [(252, 126, 126, 252), (252, 252, 252, 252),
                                    (126, 252, 0, 126)])
def test_chip_smoke_batch_gives_the_ranks_unequal_counts(counts):
    """chip_smoke's data-parallel batch: rank 1's rows (2-3) of each
    micro-batch keep their first half as many masked positions as rank
    0's rows hold, the earliest first, whatever counts the loader drew
    (here rows of 126 and 252, the RL rows' counts, which tie)."""
    import chip_smoke

    mask = np.zeros((2, 4, 1024), np.float32)
    rng = np.random.RandomState(0)
    for a in range(2):
        for r, c in enumerate(counts):
            mask[a, r, np.sort(rng.choice(1024, c, replace=False))] = 1.0
    before = mask.copy()
    chip_smoke._halve_rank1_counts(mask)
    np.testing.assert_array_equal(mask[:, :2], before[:, :2])
    assert (mask <= before).all()
    c0 = before[:, :2].sum(axis=(1, 2))
    c1 = mask[:, 2:].sum(axis=(1, 2))
    np.testing.assert_array_equal(c1, np.minimum(
        c0 // 2, before[:, 2:].sum(axis=(1, 2))))
    assert (c1 != c0).all()
    # the kept positions are rank 1's earliest, row 2 before row 3
    for a in range(2):
        flat = before[a, 2:].reshape(-1)
        kept = np.flatnonzero(flat)[:int(c1[a])]
        np.testing.assert_array_equal(np.flatnonzero(mask[a, 2:]), kept)


# ---- the Trainer, its checkpoints and resume -------------------------------

@pytest.fixture(scope="module")
def resumed(worlds):
    return dict(whole=worlds["whole"], a=worlds["whole_run"].join(),
                b=worlds["resumed_run"].join())


def test_dp_resumed_trainer_is_bitwise_equal(resumed):
    """Every rank: the parameters, the moments and the generator state
    after the resumed step 3 bitwise those of the uninterrupted run, and
    the step-3 loss equal."""
    for ra, rb in zip(resumed["a"], resumed["b"]):
        assert ra["step"] == rb["step"] == 3
        assert len(ra["losses"]) == 3 and len(rb["losses"]) == 1
        assert rb["losses"][0] == ra["losses"][2]
        assert ra["leaves"].keys() == rb["leaves"].keys()
        for n, t in ra["leaves"].items():
            assert torch.equal(t, rb["leaves"][n]), n


def test_dp_trainer_ranks_share_weights_not_generators(resumed):
    a0, a1 = (r["leaves"] for r in resumed["a"])
    for n in a0:
        if n != "generator":
            assert torch.equal(a0[n], a1[n]), n
    assert not torch.equal(a0["generator"], a1["generator"])
    assert resumed["a"][0]["losses"] == resumed["a"][1]["losses"]


def test_dp_checkpoint_is_written_once_and_loads_in_one_process(resumed):
    """The step-3 checkpoint: one file of tensors a rank (each replicated
    tensor written once), a generator state a rank, and ``load_params``
    in this one process reads rank 0's final weights from it."""
    import torch.distributed.checkpoint as dcp

    path = os.path.join(resumed["whole"], "3")
    assert sorted(f for f in os.listdir(path) if f.endswith(".distcp")) == [
        "__0_0.distcp", "__1_0.distcp"]
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    assert {"generator", "generator_rank1"} <= set(meta)
    assert sorted(os.listdir(resumed["whole"])) == ["2", "3", "metrics.jsonl"]
    steps = [json.loads(line)["step"] for line in open(
        os.path.join(resumed["whole"], "metrics.jsonl"))]
    assert steps == [1, 2, 3]
    cfg = tcfg.db1_tiny(dtype="float32")
    cfg.train.load_dir = resumed["whole"]
    model = ter.TransformerXL(cfg.model, cfg.vocab, device="cpu")
    assert ter.load_params(cfg, model) == ter.FROM_PORT
    want = resumed["a"][0]["leaves"]
    for n, p in model.named_parameters():
        assert torch.equal(p, want[f"model.{n}"]), n


def test_dp_trainer_failing_on_one_rank_ends_the_world(worlds):
    """Rank 1's loader fails before step 2 while rank 0 is inside it: rank
    1 raises its loader's error and rank 0 the step's collective error,
    both at once (a collective emergency save on rank 1 alone would hang
    the world until its timeout), and no checkpoint is written."""
    ranks = worlds["failing_run"].join()
    assert "the loader failed at batch 2" in ranks[1]["error"]
    assert ranks[0]["error"] and "RuntimeError" in ranks[0]["error"]
    assert [r["step"] for r in ranks] == [1, 1]
    assert all(r["seconds"] < tw.WORLD_TIMEOUT_S / 4 for r in ranks)
    assert os.listdir(worlds["failing"]) == ["metrics.jsonl"]


def test_make_mesh_in_a_world(worlds):
    """``make_mesh`` over the two-process world: JAX ``make_mesh``'s (2, 1)
    ("data", "model") layout, the "data" group the whole world."""
    for r in worlds["mesh"].join():
        assert r["shape"] == (WORLD, 1)
        assert r["names"] == ("data", "model")
        assert r["sizes"] == {"data": WORLD, "model": 1}
        assert r["data_rank_sum"] == 1.0


# ---- evaluate_rl.main over an uneven shard ---------------------------------

def test_dp_evaluate_rl_main_matches_jax(worlds):
    """Three envs over two ranks (rank 0: the first and third, rank 1: the
    second), one episode loop each: rank 0's gathered records are JAX's
    one-process records in rank-major order, with JAX's suite summary;
    rank 1 holds the same records without it; results.output holds rank
    0's lines once."""
    from bdm_db1_tpu.eval.evaluate_rl import main as jmain

    want = jmain(worlds["eval_cfgs"][0])
    ranks = worlds["eval"].join()
    assert [r["shard"] for r in ranks] == [[EVAL_ENVS[0], EVAL_ENVS[2]],
                                           [EVAL_ENVS[1]]]
    by_env = {r["env"]: r for r in want[:-1]}
    order = [EVAL_ENVS[0], EVAL_ENVS[2], EVAL_ENVS[1]]
    got0, got1 = (r["records"] for r in ranks)
    assert got0[:-1] == [by_env[n] for n in order]
    assert got0[-1] == want[-1] and "suite_summary" in want[-1]
    assert got1 == got0[:-1]
    lines = (worlds["tmp"] / "port" / "results.output").read_text()
    assert lines.splitlines() == [json.dumps(r) for r in got0]


# ---- pretrain.main in a world ----------------------------------------------

def test_dp_pretrain_main_runs_in_a_world(worlds):
    """Each rank's loader takes its shard: accum 2 of 4-row micro-batches
    (2 text + 2 RL rows) for the global batch of 16; rank 0 alone prints
    and logs each iteration once, the eval hook's validation loss and
    rollout at the 3rd; the step-3 checkpoint is written by both ranks."""
    out0, out1 = worlds["pretrain"].join()
    assert "2 processes" in out0 and out1 == ""
    assert "batch groups: nlp [2, 2, 64], rl [2, 2, 64]" in out0
    run = worlds["pretrain_cfg"].train.save_dir
    recs = [json.loads(line) for line in
            open(os.path.join(run, "metrics.jsonl")).read().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["train/loss"]) for r in train)
    valid = [r for r in recs if "valid/loss" in r]
    assert len(valid) == 1 and valid[0]["step"] == 3
    assert np.isfinite(valid[0]["valid/loss"])
    assert valid[0][f"valid/length/{PRETRAIN_ENV}"] == 2.0
    step3 = os.path.join(run, "3")
    assert sorted(f for f in os.listdir(step3) if f.endswith(".distcp")) == [
        "__0_0.distcp", "__1_0.distcp"]
