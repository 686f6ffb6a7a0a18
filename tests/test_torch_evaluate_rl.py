"""The port's RL evaluation driver (bdm_db1_tpu_torch/eval/evaluate_rl.py)
against the JAX package's, on the CPU at db1_tiny in f32: the trajectory
caches of tests/test_drivers.py written by both packages byte for byte,
``main`` through both packages on the same DeepSpeed weights and caches
(one-env loop, batched over 3 envs of 2 geometries, the suite summary;
the first two also at the default geometry buckets) with equal records
and ``results.output`` lines, ``load_params``' three sources,
``shard_envs``, the discrete fake env, the continuous one's random walk
and what raises."""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from bdm_db1_tpu.core.config import db1_tiny as jdb1_tiny
from bdm_db1_tpu.data import rl_dataset as jd
from bdm_db1_tpu.eval import envs as je
from bdm_db1_tpu.eval import harness as jh
from bdm_db1_tpu_torch.core import config as tcfg
from bdm_db1_tpu_torch.data import rl_dataset as td
from bdm_db1_tpu_torch.eval import envs as te
from bdm_db1_tpu_torch.eval import evaluate_rl as ter
from bdm_db1_tpu_torch.eval.decode import DEFAULT_OBS_BUCKETS
from bdm_db1_tpu_torch.eval import harness as th
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
from bdm_db1_tpu_torch.train.checkpoint import CheckpointManager
from bdm_db1_tpu_torch.train.convert import state_dict_from_jax
from bdm_db1_tpu_torch.train.step import init_train_state
from tests.torch_port_helpers import jax_tiny, one_thread

TAG = "db1_tiny_checkpoint"
# (env name, factory kwargs, episodes in its cache): tests/test_drivers.py's
CACHES = [("fake-continuous-v0", "continuous", dict(episode_len=8)),
          ("fake-continuous-b-v0", "continuous", dict(seed=5, episode_len=6)),
          ("fake-discrete-v0", "discrete", dict(episode_len=7))]


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _env(pkg, kind, kw):
    return (pkg.FakeContinuousEnv if kind == "continuous"
            else pkg.FakeDiscreteEnv)(**kw)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The caches of tests/test_drivers.py, once through each package's
    save_cache, the second geometry's env registered in both, and the JAX
    db1_tiny params written as a DeepSpeed checkpoint."""
    from bdm_db1_tpu.train.convert import save_deepspeed_checkpoint

    tmp = tmp_path_factory.mktemp("evaluate_rl")
    for name, kind, kw in CACHES:
        jd.TrajectoryStore.from_flat_dataset(
            _env(je, kind, kw).make_dataset(5)).save_cache(
            str(tmp / "rl_jax"), name)
        td.TrajectoryStore.from_flat_dataset(
            _env(te, kind, kw).make_dataset(5)).save_cache(
            str(tmp / "rl_port"), name)
    kw_b = CACHES[1][2]
    je.register_env("fake-continuous-b-v0",
                    lambda: je.FakeContinuousEnv(**kw_b))
    te.register_env("fake-continuous-b-v0",
                    lambda: te.FakeContinuousEnv(**kw_b))
    cfg, _, params, _ = jax_tiny()
    save_deepspeed_checkpoint(params, cfg, str(tmp / "ckpt"), TAG)
    return tmp


def _cfgs(tmp, **eval_kw):
    """(JAX config, port config): db1_tiny in f32 on the JAX-written
    caches and the DeepSpeed weights, geometry buckets off unless
    ``eval_kw`` turns them on."""
    eval_kw = {"decode_obs_buckets": False, **eval_kw}
    out = []
    for mk in (jdb1_tiny, tcfg.db1_tiny):
        cfg = mk()
        cfg.model.dtype = "float32"
        cfg.data.rl_dataset_cache_dir = str(tmp / "rl_jax")
        cfg.data.seq_length = cfg.model.n_position
        cfg.train.load_dir, cfg.train.ckpt_tag = str(tmp / "ckpt"), TAG
        cfg.eval = dataclasses.replace(cfg.eval, **eval_kw)
        out.append(cfg)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_caches_are_byte_equal(workspace):
    a, b = workspace / "rl_jax", workspace / "rl_port"
    names = _files(a)
    assert names == _files(b) and len(names) == 3 * (2 + 3 * 5)
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("name", [c[0] for c in CACHES])
def test_dataset_meta_and_index_match_jax(name, workspace, tmp_path):
    """The port reads a JAX-written cache into the same store and writes the
    same meta and sample-index files as the JAX package."""
    from bdm_db1_tpu.tokenizers.scalar import ScalarTokenizer as JScalar
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer

    jcfg, pcfg = _cfgs(workspace)
    dirs = {}
    for pkg, cfg, scalar in ((jd, jcfg, JScalar), (td, pcfg, ScalarTokenizer)):
        root = tmp_path / pkg.__name__
        suite = pkg.RLTokenizerSuite(cfg.vocab.layout(),
                                     scalar(cfg.vocab.num_continuous_bin))
        store = pkg.TrajectoryStore.from_cache_dir(str(workspace / "rl_jax"),
                                                   name)
        ds = pkg.RLFullDataset(name, store, suite, 64, cache_dir=str(root))
        dirs[pkg] = (root / name / "meta", ds)
    (ja, jds), (pa, pds) = dirs[jd], dirs[td]
    names = _files(ja)
    assert names == _files(pa) and "indices_64.npy" in names
    assert not filecmp.cmpfiles(ja, pa, names, shallow=False)[1]
    # read back from the meta cache: the same dataset
    again = td.RLFullDataset(name, pds.store, pds.tok, 64,
                             cache_dir=str(tmp_path / td.__name__))
    for attr in ("observation_dim", "action_dim", "transition_num",
                 "obs_type_spec"):
        assert getattr(again, attr) == getattr(jds, attr), attr
    np.testing.assert_array_equal(again.indices, jds.indices)
    for i in range(jds.store.num_trajectories):
        for a, b in zip(jds.store.get(i, 1, 4), again.store.get(i, 1, 4)):
            np.testing.assert_array_equal(a, b)


# the three evaluate_rl cases of tests/test_drivers.py (:114, :131, :176),
# and the first two at the default config (geometry buckets on)
MAIN_CASES = {
    "unbatched": dict(env_names=("fake-continuous-v0",), num_trials=1,
                      max_step_size=4, batched=False),
    "batched": dict(env_names=("fake-continuous-v0", "fake-continuous-b-v0",
                               "fake-discrete-v0"),
                    num_trials=2, max_step_size=3, batch_size=4),
    "suite_summary": dict(env_names=("fake-continuous-v0",), num_trials=1,
                          max_step_size=3, batched=False),
}
for _case in ("unbatched", "batched"):
    MAIN_CASES[_case + "_buckets"] = dict(MAIN_CASES[_case],
                                          decode_obs_buckets=True)


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_matches_jax(case, workspace, tmp_path, capsys):
    from bdm_db1_tpu.eval.evaluate_rl import main as jmain

    kw = dict(MAIN_CASES[case])
    if case == "suite_summary":
        base = tmp_path / "baselines.json"
        base.write_text(json.dumps(
            {"fake-continuous-v0": {"random": -100.0, "expert": 0.0}}))
        kw["baselines_path"] = str(base)
    jcfg, pcfg = _cfgs(workspace, **kw)
    jcfg.train.save_dir = str(tmp_path / "jax")
    pcfg.train.save_dir = str(tmp_path / "port")
    want = jmain(jcfg)
    pools = []
    real_pool = ter.DecoderPool

    def keeping(*a, **k):
        pools.append(real_pool(*a, **k))
        return pools[-1]

    ter.DecoderPool = keeping
    try:
        got = ter.main(pcfg, device="cpu")
    finally:
        ter.DecoderPool = real_pool
    widths = set(pools[0].rk_cache.widths())
    if kw.get("decode_obs_buckets"):
        # every prime padded to a bucket width (the 32-token prompt
        # slices are one), the action tokens at q == 1
        assert pools[0].pad_buckets == "default"
        assert widths <= {1, *DEFAULT_OBS_BUCKETS}, widths
    else:
        assert not widths <= {1, *DEFAULT_OBS_BUCKETS}, widths
    assert "loading DeepSpeed checkpoint" in capsys.readouterr().out
    assert got == want
    lines = {k: (tmp_path / k / "results.output").read_text().splitlines()
             for k in ("jax", "port")}
    assert lines["port"] == lines["jax"]
    n_envs = len(kw["env_names"])
    assert len(got) == n_envs + (case == "suite_summary")
    assert all(np.isfinite(r["return_mean"]) for r in got[:n_envs])
    if case == "suite_summary":
        assert got[-1]["suite_summary"]["num_tasks"] == 1.0


def _port_model(cfg, seed):
    return TransformerXL(cfg.model, cfg.vocab, device="cpu",
                         generator=torch.Generator().manual_seed(seed))


def test_load_params_reads_the_deepspeed_checkpoint(workspace):
    """The DeepSpeed weights (the JAX params rounded to fp16) in the port's
    layout, padded vocab rows included. The file has no vision tower (the
    JAX model was initialised on RL batches): the port's stays at its
    seeded init."""
    _, pcfg = _cfgs(workspace)
    model = _port_model(pcfg, 3)
    init = {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith("vision_encoder.")}
    assert ter.load_params(pcfg, model) == ter.FROM_DEEPSPEED
    import jax

    half = jax.tree.map(lambda x: np.asarray(x, np.float16).astype(
        np.float32), jax_tiny()[3])
    want, _ = state_dict_from_jax(half, pcfg)
    # a DeepSpeed file holds the real vocab rows only; the pad is zeros
    want["word_embedding.weight"][
        pcfg.vocab.layout().total_vocab_size:] = 0.0
    got = model.state_dict()
    assert got.keys() == want.keys() | init.keys() and len(init) == 14
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in init:
        assert torch.equal(got[k], init[k]), k


def test_load_params_reads_the_port_checkpoint(workspace, tmp_path):
    """A training checkpoint's model tensors (f32) into a bf16 model: the
    saved weights cast to bf16; the latest step is read."""
    _, pcfg = _cfgs(workspace)
    trained = _port_model(pcfg, 1)
    state = init_train_state(trained, pcfg.train.optimizer, 10)
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(5, state, client_state={"iteration": 5})
    with torch.no_grad():
        for p in trained.parameters():
            p.add_(1.0)
    mgr.save(7, state, client_state={"iteration": 7})
    pcfg.train.load_dir = mgr.directory
    pcfg.model.param_dtype = "bfloat16"
    model = _port_model(pcfg, 2)
    assert ter.load_params(pcfg, model) == ter.FROM_PORT
    want = trained.state_dict()
    for k, v in model.state_dict().items():
        assert v.dtype == (torch.bfloat16 if v.is_floating_point()
                           and k != "pos_emb.inv_freq" else v.dtype)
        assert torch.equal(v, want[k].to(v.dtype)), k


def test_load_params_falls_back_to_a_seeded_random_init(tmp_path):
    cfg = tcfg.db1_tiny(dtype="float32")
    cfg.train.load_dir = str(tmp_path / "empty")
    got = []
    for seed in (0, 1):
        model = _port_model(cfg, seed)
        assert ter.load_params(cfg, model) == ter.FROM_RANDOM
        got.append(model.state_dict())
    assert all(torch.equal(got[0][k], got[1][k]) for k in got[0])
    ref = _port_model(cfg, cfg.eval.seed).state_dict()
    assert all(torch.equal(got[0][k], ref[k]) for k in ref)


def test_load_params_refuses_a_jax_checkpoint(tmp_path):
    """An orbax step directory is not read as a port checkpoint."""
    cfg = tcfg.db1_tiny(dtype="float32")
    (tmp_path / "orbax" / "3" / "state").mkdir(parents=True)
    cfg.train.load_dir = str(tmp_path / "orbax")
    with pytest.raises(ValueError, match="save_deepspeed_checkpoint") as e:
        ter.load_params(cfg, _port_model(cfg, 0))
    # the JAX package's function for orbax files, the port's for its own
    assert e.match(r"bdm_db1_tpu\.train\.convert\.save_deepspeed")
    assert e.match(r"bdm_db1_tpu_torch\.train\.convert\.save_deepspeed")


@pytest.mark.parametrize("n,pi,pc", [(5, 0, 1), (5, 0, 2), (5, 1, 2),
                                     (7, 2, 3), (2, 3, 4), (0, 0, 2)])
def test_shard_envs_matches_jax(n, pi, pc):
    names = [f"env-{i}" for i in range(n)]
    assert th.shard_envs(names, pi, pc) == jh.shard_envs(names, pi, pc)
    assert th.shard_envs(names) == names


@pytest.mark.parametrize("kw", [dict(), dict(obs_dim=5, n_actions=6,
                                             episode_len=4, seed=3)])
def test_fake_discrete_env_matches_jax(kw):
    j, t = je.FakeDiscreteEnv(**kw), te.FakeDiscreteEnv(**kw)
    jdata, tdata = j.make_dataset(3), t.make_dataset(3)
    assert jdata.keys() == tdata.keys()
    for k in jdata:
        assert jdata[k].dtype == tdata[k].dtype, k
        np.testing.assert_array_equal(jdata[k], tdata[k])
    j.seed(9)
    t.seed(9)
    np.testing.assert_array_equal(j.reset(), t.reset())
    for a in (0, 1, 2, 3):
        jo, jr, jdone, _ = j.step(a)
        to, tr, tdone, _ = t.step(a)
        np.testing.assert_array_equal(jo, to)
        assert (jr, jdone) == (tr, tdone)


@pytest.mark.parametrize("walk_sigma", [0.0, 0.05])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fake_continuous_env_walk_matches_jax(seed, walk_sigma):
    """Two episodes of 6 steps under a fixed action: the observations,
    rewards and ``done`` equal to JAX's; the walk moves each observation
    at most 5 sigma from the last, and a reset draws a fresh start."""
    kw = dict(obs_dim=5, act_dim=2, episode_len=6, seed=seed)
    j = je.FakeContinuousEnv(walk_sigma=walk_sigma, **kw)
    t = te.FakeContinuousEnv(walk_sigma=walk_sigma, **kw)
    plain = te.FakeContinuousEnv(**kw)
    action = np.array([0.3, -0.2], np.float32)
    starts = []
    for _ in range(2):
        jo, to, po = j.reset(), t.reset(), plain.reset()
        np.testing.assert_array_equal(jo, to)
        if not (walk_sigma and starts):     # the first start: one draw
            np.testing.assert_array_equal(to, po)
        starts.append(to)
        done = False
        while not done:
            last = to
            jo, jr, jdone, _ = j.step(action)
            to, tr, done, _ = t.step(action)
            po = plain.step(action)[0]
            assert to.dtype == jo.dtype == np.float32
            np.testing.assert_array_equal(jo, to)
            assert (jr, jdone) == (tr, done)
            if walk_sigma:
                assert np.abs(to - last).max() <= 5 * walk_sigma
            else:
                np.testing.assert_array_equal(to, po)
    assert not np.array_equal(*starts)


@pytest.mark.parametrize("field,value,error,match", [
    # sharded decode over a model_parallel (3) that does not divide
    # db1_tiny's 4 heads: a rank cannot hold a fraction of a head
    ("sharded_decode", True, ValueError, "n_head"),
    # a multi-process run without the launcher's rendezvous address raises
    # instead of evaluating in one process
    ("multihost", True, ValueError, "MASTER_ADDR")])
def test_unported_options_raise(field, value, error, match, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    cfg = tcfg.db1_tiny(dtype="float32")
    cfg.eval.decode_obs_buckets = False
    section = cfg.mesh if field == "multihost" else cfg.eval
    setattr(section, field, value)
    if field == "sharded_decode":
        cfg.mesh.model_parallel = 3
    with pytest.raises(error, match=match):
        ter.main(cfg, device="cpu")


@pytest.mark.parametrize("name", ["fake-image-v0", "fake-text-v0",
                                  "no-such-env-v0"])
def test_make_env_rejects_unported_and_unknown_names(name):
    if name == "fake-image-v0":
        # ported with the image path: made as the JAX registry makes it
        env = te.make_env(name)
        assert isinstance(env, te.FakeImageEnv)
        assert env.reset().shape == (3, 32, 32) and env.action_space.n == 4
        return
    if name == "fake-text-v0":
        # ported with text observations: made as the JAX registry makes it
        env = te.make_env(name)
        assert isinstance(env, te.FakeTextEnv)
        obs = env.reset()
        assert obs["image"].shape == (3, 32, 32) and env.action_space.n == 7
        assert str(obs["mission"]) in te.FakeTextEnv.MISSIONS
        return
    with pytest.raises(ValueError, match="unknown env"):
        te.make_env(name)


def test_suite_env_names_needs_d4rl():
    from bdm_db1_tpu.eval.evaluate_rl import suite_env_names

    for fn in (suite_env_names, ter.suite_env_names):
        with pytest.raises(ImportError):
            fn("locomotion")
