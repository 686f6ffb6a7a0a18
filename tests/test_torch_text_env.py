"""Text observations (BabyAI-style: a mission string and an RGB frame) in
the port against the JAX package's, on the CPU at db1_tiny in f32: the
fake text env's streams and datasets, the text obs meta and tokens
(``obs_dim_of``, ``encode_obs_leaf``, ``assemble_obs_tokens``, the batch
encode), packed samples and expert prompts, the trajectory cache with a
string leaf, one loss-and-gradient step on text-and-image rows, the
lockstep harness and ``evaluate_rl.main`` on ``fake-text-v0``, and the
ring decode of a text-and-image prime (the counterpart of
tests/test_text_env.py)."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tiny, one_thread, port_model, to_numpy

# one deterministic step's loss and gradients
# (tests/test_torch_train_step.py's bars)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
_NO_DROP = dict(drop=0.0, embd_pdrop=0.0, dropattn=0.0)
N_ACTIONS, EP_LEN = 4, 5


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _suite(pkg_rd, pkg_scalar, pkg_text, cfg):
    return pkg_rd.RLTokenizerSuite(
        cfg.vocab.layout(), pkg_scalar(cfg.vocab.num_continuous_bin),
        pkg_text(), vision_patch_size=cfg.vision.patch_size)


def _packages():
    """(JAX modules, port modules): (rl_dataset, envs, wrapper, scalar
    tokenizer, text tokenizer, config)."""
    from bdm_db1_tpu.core import config as jc
    from bdm_db1_tpu.data import rl_dataset as jd
    from bdm_db1_tpu.eval import envs as je
    from bdm_db1_tpu.eval import wrapper as jw
    from bdm_db1_tpu.tokenizers.scalar import ScalarTokenizer as JScalar
    from bdm_db1_tpu.tokenizers.text import ByteTextTokenizer as JText
    from bdm_db1_tpu_torch.core import config as tc
    from bdm_db1_tpu_torch.data import rl_dataset as td
    from bdm_db1_tpu_torch.eval import envs as te
    from bdm_db1_tpu_torch.eval import wrapper as tw
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer as TScalar
    from bdm_db1_tpu_torch.tokenizers.text import ByteTextTokenizer as TText

    return ((jd, je, jw, JScalar, JText, jc), (td, te, tw, TScalar, TText, tc))


def _setup(cache_dir=None):
    """Per package: (dataset "text-geom" over 3 episodes of a seeded
    FakeTextEnv, env factory), JAX first."""
    out = []
    for rd, envs, _, scalar, text, conf in _packages():
        cfg = conf.db1_tiny()
        hw = 2 * cfg.vision.patch_size

        def env_fn(seed=0, envs=envs, hw=hw):
            return envs.FakeTextEnv(hw=hw, n_actions=N_ACTIONS,
                                    episode_len=EP_LEN, seed=seed)

        store = rd.TrajectoryStore.from_flat_dataset(
            env_fn(99).make_dataset(3))
        ds = rd.RLFullDataset("text-geom", store,
                              _suite(rd, scalar, text, cfg),
                              seq_length=cfg.model.n_position,
                              use_prompt=True, seed=0, cache_dir=cache_dir)
        out.append((ds, env_fn))
    return out


def _tree_equal(a, b, what=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            _tree_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{what}[{i}]")
    elif a is None:
        assert b is None, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                          b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("kw", [dict(), dict(hw=16, n_actions=5,
                                             episode_len=3, seed=4)])
def test_fake_text_env_matches_jax(kw):
    """Same seed, same missions, frames, rewards and dataset."""
    (_, je, *_), (_, te, *_) = _packages()
    j, t = je.FakeTextEnv(**kw), te.FakeTextEnv(**kw)
    assert te.FakeTextEnv.MISSIONS == je.FakeTextEnv.MISSIONS
    _tree_equal(t.make_dataset(3), j.make_dataset(3), "dataset")
    j.seed(9)
    t.seed(9)
    _tree_equal(t.reset(), j.reset(), "reset")
    for a in range(2 * j.episode_len):
        jo, jr, jdone, _ = j.step(a)
        to, tr, tdone, _ = t.step(a)
        _tree_equal(to, jo, f"step {a}")
        assert (tr, tdone) == (jr, jdone)
        if tdone:
            _tree_equal(t.reset(), j.reset(), "reset")
    assert isinstance(te.make_env("fake-text-v0"), te.FakeTextEnv)


def test_text_obs_meta_and_tokens_match_jax():
    """obs_dim = the mission's byte tokens + the frame's patches; the text
    tokens lead the observation, the -1 image slots follow; the port's
    meta, leaf encodings and env tokens are JAX's."""
    (jds, jenv), (tds, tenv) = _setup()
    (_, _, jw, *_), (_, te, tw, *_) = _packages()
    mission_len = len(te.FakeTextEnv.MISSIONS[0])    # one byte, one token
    n_patches = 4                                    # 32 x 32, patch 16
    for attr in ("obs_type_spec", "observation_dims_for_spec",
                 "observation_dim", "action_dim", "transition_num",
                 "step_size"):
        assert getattr(tds, attr) == getattr(jds, attr), attr
    assert tds.observation_dim == mission_len + n_patches
    assert tds.obs_type_spec == {"mission": "text", "image": "image"}
    obs, _ = tds.store.get(0)
    for k, typ in tds.obs_type_spec.items():
        x = np.asarray(obs[k])
        d = tds.tok.obs_dim_of(x, typ)
        assert d == jds.tok.obs_dim_of(x, typ)
        _tree_equal(tds.tok.encode_obs_leaf(x, typ, d),
                    jds.tok.encode_obs_leaf(x, typ, d), k)
    jt, tt = jw.TokenizedEnv(jenv(0), jds), tw.TokenizedEnv(tenv(0), tds)
    (tok, img, mask), (jtok, jimg, jmask) = tt.reset(), jt.reset()
    _tree_equal(tok, jtok, "tokens")
    _tree_equal(img, jimg, "image")
    assert mask is None and jmask is None
    assert tok.shape == (tds.observation_dim,)
    assert (tok[:mission_len] > 0).all()
    assert (tok[:mission_len] < tds.tok.layout.text_vocab_size).all()
    assert (tok[mission_len:] == -1).all()
    assert img.shape == (1, 32, 32, 3)


def test_text_obs_batch_encode_matches_jax():
    """``encode_obs_batch`` over mission + frame observations equals the
    per-env ``encode_obs`` rows and JAX's batch."""
    (jds, jenv), (tds, tenv) = _setup()
    (_, _, jw, *_), (_, _, tw, *_) = _packages()
    te_, je_ = tw.TokenizedEnv(tenv(1), tds), jw.TokenizedEnv(jenv(1), jds)
    raws = [te_.env.reset() for _ in range(4)]
    bt, bi = te_.encode_obs_batch(raws)
    st = np.stack([te_.encode_obs(r)[0] for r in raws])
    si = np.concatenate([te_.encode_obs(r)[1] for r in raws], axis=0)
    np.testing.assert_array_equal(bt, st)
    np.testing.assert_array_equal(bi, si)
    jt, ji = je_.encode_obs_batch(raws)
    _tree_equal(bt, jt, "tokens")
    _tree_equal(bi, ji, "images")


def test_text_samples_and_prompts_match_jax():
    """Packed samples (prompt conditioning drawn in JAX's order) key for
    key, the expert demonstrations of both prompt strategies (with an
    ``obs/text`` leaf) and the tokenized env's prompts."""
    (jds, jenv), (tds, tenv) = _setup()
    (_, _, jw, *_), (_, _, tw, *_) = _packages()
    assert len(tds) == len(jds)
    for i in list(range(0, len(tds), 3)) + [len(tds) - 1]:
        got, want = tds.get(i), jds.get(i)
        _tree_equal(got, want, f"sample {i}")
        step = tds.step_size
        assert (got["tokens"][tds.observation_dim] ==
                tds.tok.layout.separator_id)
        assert step == tds.observation_dim + 2
    for strategy in ("fixed_prompt", "moving_prompt"):
        for strict in (True, False):
            rng_t, rng_j = (np.random.RandomState(5) for _ in range(2))
            got = tds.sample_expert_demonstration(strategy, strict, True,
                                                  rng_t)
            want = jds.sample_expert_demonstration(strategy, strict, True,
                                                   rng_j)
            assert got["obs/text"] is not None
            _tree_equal(got, want, f"{strategy} {strict}")
    for strategy in ("fixed_prompt", "moving_prompt"):
        t = tw.TokenizedEnv(tenv(2), tds, eval_prompt_strategy=strategy)
        j = jw.TokenizedEnv(jenv(2), jds, eval_prompt_strategy=strategy)
        got = t.get_prompt(rng=np.random.RandomState(1))
        want = j.get_prompt(rng=np.random.RandomState(1))
        _tree_equal(got[0], want[0], strategy)
        _tree_equal(got[1], want[1], strategy)


def test_text_cache_round_trip_matches_jax(tmp_path):
    """``save_cache`` of a string observation leaf writes JAX's files byte
    for byte; ``from_cache_dir`` reads them back in both packages, and a
    dataset over the cache writes and reads JAX's meta."""
    (jd, je, *_), (td, te, *_) = _packages()
    data = je.FakeTextEnv(hw=32, seed=3).make_dataset(3)
    jd.TrajectoryStore.from_flat_dataset(data).save_cache(
        str(tmp_path / "jax"), "fake-text-v0")
    td.TrajectoryStore.from_flat_dataset(
        te.FakeTextEnv(hw=32, seed=3).make_dataset(3)).save_cache(
        str(tmp_path / "port"), "fake-text-v0")
    files = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        files[side] = sorted(os.path.relpath(os.path.join(d, f), root)
                             for d, _, fs in os.walk(root) for f in fs)
    assert files["jax"] == files["port"] and files["jax"]
    assert any("mission" in f for f in files["jax"])
    for f in files["jax"]:
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f,
                           shallow=False), f
    js = jd.TrajectoryStore.from_cache_dir(str(tmp_path / "jax"),
                                           "fake-text-v0")
    ts = td.TrajectoryStore.from_cache_dir(str(tmp_path / "jax"),
                                           "fake-text-v0")
    assert ts.num_trajectories == js.num_trajectories
    for i in range(ts.num_trajectories):
        _tree_equal(ts.get(i), js.get(i), f"trajectory {i}")
    (jds, _), (tds, _) = _setup(str(tmp_path / "meta"))
    (jds2, _), (tds2, _) = _setup(str(tmp_path / "meta"))
    for attr in ("obs_type_spec", "observation_dims_for_spec",
                 "observation_dim", "transition_num"):
        assert getattr(tds2, attr) == getattr(jds2, attr) == getattr(
            tds, attr), attr


def test_text_rows_train_step_matches_jax():
    """The loss and every gradient leaf (the vision tower's among them)
    of one deterministic step (eval patch positions, dropout 0) on an RL
    batch of packed text-and-image rows, through the JAX loss and the
    port's forward."""
    import jax
    import jax.numpy as jnp

    from bdm_db1_tpu.data.input_specs import RLTaskBatch as JRL
    from bdm_db1_tpu_torch.core import config as tcfg
    from bdm_db1_tpu_torch.data.samplers import collate_modalities
    from bdm_db1_tpu_torch.train.convert import state_dict_from_jax
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    (jds, _), (tds, _) = _setup()
    idx = [0, 4, 9]
    raw = collate_modalities([tds.get(i) for i in idx], ["rl"])
    assert raw["rl"]["images"].shape[:2] == (3, tds.transition_num)
    _, jm, params, pnp = jax_tiny(vision=True, **_NO_DROP)
    jbatch = {"rl": JRL(**{k: jnp.asarray(v) for k, v in raw["rl"].items()})}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.apply({"params": p}, b, deterministic=True,
                              loss_only=True)[1]))(params, jbatch)
    j_sd, _ = state_dict_from_jax(to_numpy(j_grads), tcfg.db1_tiny())
    port = port_model(pnp, **_NO_DROP)
    named = list(port.named_parameters())
    _, loss = port(to_gato_batch(raw, "cpu"), deterministic=True,
                   loss_only=True)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    assert abs(float(loss.detach()) - float(j_loss)) <= LOSS_RTOL * abs(
        float(j_loss))
    assert sum(n.startswith("vision_encoder.") for n, _ in named) == 14
    for (name, _), g in zip(named, grads):
        ref = j_sd[name].numpy()
        assert float(np.abs(ref).max()) > 0 or name.endswith("bias"), name
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=name)


def test_text_env_lockstep_matches_jax():
    """``evaluate_envs_lockstep`` over three text envs in cohorts of two:
    the prompt primes (text + frame transitions through the image chunk
    plan), one discrete action token a step, JAX's records exactly."""
    from bdm_db1_tpu.eval.harness import evaluate_envs_lockstep as jeval
    from bdm_db1_tpu_torch.eval.harness import evaluate_envs_lockstep

    (jds, jenv), (tds, tenv) = _setup()
    (_, _, jw, *_), (_, _, tw, *_) = _packages()
    _, jm, params, pnp = jax_tiny(vision=True)
    names = [f"text-{i}" for i in range(3)]
    kw = dict(num_trials=1, seed=7, batch_size=2)
    want = jeval(jm, params, names, lambda n: jw.TokenizedEnv(
        jenv(int(n.split("-")[-1])), jds), **kw)
    got = evaluate_envs_lockstep(port_model(pnp), names, lambda n: tw.
                                 TokenizedEnv(tenv(int(n.split("-")[-1])),
                                              tds), **kw)
    assert got == want
    assert all(r["length_mean"] == EP_LEN for r in got)


@pytest.fixture(scope="module")
def text_workspace(tmp_path_factory):
    """The fake-text-v0 cache written by the JAX package and the JAX
    db1_tiny params with the vision tower as a DeepSpeed checkpoint."""
    from bdm_db1_tpu.data import rl_dataset as jd
    from bdm_db1_tpu.eval import envs as je
    from bdm_db1_tpu.train.convert import save_deepspeed_checkpoint

    tmp = tmp_path_factory.mktemp("text_main")
    jd.TrajectoryStore.from_flat_dataset(
        je.make_env("fake-text-v0").make_dataset(4)).save_cache(
        str(tmp / "rl"), "fake-text-v0")
    cfg, _, params, _ = jax_tiny(vision=True)
    save_deepspeed_checkpoint(params, cfg, str(tmp / "ckpt"), "text")
    return tmp


@pytest.mark.parametrize("batched,buckets", [(True, True), (False, False)])
def test_text_env_main_matches_jax(batched, buckets, text_workspace,
                                   tmp_path):
    """``evaluate_rl.main`` on ``fake-text-v0`` (18 mission tokens and 4
    frame patches an observation) from the same DeepSpeed weights and
    cache: the port's records and ``results.output`` are JAX's."""
    from bdm_db1_tpu.core.config import db1_tiny as jdb1
    from bdm_db1_tpu.eval.evaluate_rl import main as jmain
    from bdm_db1_tpu_torch.core import config as tcfg
    from bdm_db1_tpu_torch.eval import evaluate_rl as ter

    cfgs = []
    for mk, side in ((jdb1, "jax"), (tcfg.db1_tiny, "port")):
        cfg = mk()
        cfg.model.dtype = "float32"
        cfg.data.rl_dataset_cache_dir = str(text_workspace / "rl")
        cfg.train.load_dir = str(text_workspace / "ckpt")
        cfg.train.ckpt_tag = "text"
        cfg.train.save_dir = str(tmp_path / side)
        cfg.eval = dataclasses.replace(
            cfg.eval, env_names=("fake-text-v0",), num_trials=3,
            batched=batched, batch_size=2, max_step_size=4,
            decode_obs_buckets=buckets)
        cfgs.append(cfg)
    want = jmain(cfgs[0])
    got = ter.main(cfgs[1], device="cpu")
    assert got == want and len(got) == 1
    assert got[0]["length_mean"] == 4.0
    lines = [(tmp_path / s / "results.output").read_text()
             for s in ("jax", "port")]
    assert lines[0] == lines[1]


def test_text_ring_decode_matches_jax():
    """A text-and-image prime (an expert prompt of text transitions, then
    the reset observation) through the ring decode: the greedy discrete
    action and the next steady step's are JAX's, in the env's action
    range, and a second decode from a fresh cache repeats them."""
    from bdm_db1_tpu.eval.decode import build_decoder_for_env as jbuild
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env

    (jds, jenv), (tds, tenv) = _setup()
    (_, _, jw, *_), (_, _, tw, *_) = _packages()
    _, jm, params, pnp = jax_tiny(vision=True, seed=1)
    te_ = tw.TokenizedEnv(tenv(3), tds)
    prompt, pimg = te_.get_prompt(rng=np.random.RandomState(0))
    obs, img, _ = te_.reset()
    sep = np.array([te_.separator_id], np.int64)
    prime = np.concatenate([prompt, obs, sep])
    frames = np.concatenate([pimg, img])
    nxt, nimg, _ = te_.reset()
    jdec = jbuild(jm, params, jw.TokenizedEnv(jenv(3), jds))
    tdec = build_decoder_for_env(port_model(pnp), te_)
    out = []
    for dec in (jdec, tdec, tdec):
        mems = dec.init_mems(1)
        a, mems = dec.decode(prime, mems, prime_images=frames,
                             defer_last=True)
        b, _ = dec.decode(np.concatenate([nxt, sep]), mems,
                          prime_images=nimg, deferred_tok=np.asarray(a)[-1:],
                          defer_last=True)
        out.append((np.asarray(a), np.asarray(b)))
    for g in out[1:]:
        _tree_equal(g[0].astype(np.int64), out[0][0].astype(np.int64))
        _tree_equal(g[1].astype(np.int64), out[0][1].astype(np.int64))
    lo = tds.tok.layout.discrete_offset
    assert out[1][0].shape == (1,) and lo <= int(out[1][0][0]) < lo + N_ACTIONS
