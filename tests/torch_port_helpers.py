"""Shared set-up of the PyTorch-port tests (tests/test_torch_*.py): one tiny
JAX model with its params, the same weights loaded into the port through
the weight bridge, and matching fake-env datasets in both packages."""

from __future__ import annotations

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from bdm_db1_tpu.core.config import db1_tiny
from bdm_db1_tpu.data.input_specs import RLTaskBatch
from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
from bdm_db1_tpu_torch.core import config as port_config
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL as PortTXL
from bdm_db1_tpu_torch.train.convert import load_jax_params


def jax_tiny(decode_flash: str = "off", seed: int = 0, vision: bool = False,
             **model_overrides):
    """db1_tiny in f32: (cfg, model, params, params as numpy). The params
    are the unquantized ones whatever ``decode_weight_dtype`` says; with
    ``vision`` the model was initialised on an image-RL batch, so the tree
    has the vision subtree."""
    cfg = db1_tiny()
    cfg.model.dtype = "float32"
    cfg.model.decode_flash = decode_flash
    for key, val in model_overrides.items():
        setattr(cfg.model, key, val)
    params, pnp = _tiny_params(seed, vision)
    return cfg, JaxTXL(cfg.model, cfg.vocab, cfg.vision), params, pnp


@functools.lru_cache(maxsize=None)
def _tiny_params(seed: int, vision: bool = False):
    """One init per seed for every test file of a process (the weights do
    not depend on the decode switches)."""
    cfg = db1_tiny()
    cfg.model.dtype = "float32"
    model = JaxTXL(cfg.model, cfg.vocab, cfg.vision)
    tok = jnp.zeros((1, cfg.model.n_position), jnp.int32)
    if not vision:
        params = model.init(jax.random.PRNGKey(seed), {"rl": RLTaskBatch(
            tokens=tok, position_id=tok, loss_mask=tok, label=tok)})["params"]
        return params, to_numpy(params)
    tok = tok.at[0, 0].set(-1)
    hw = 2 * cfg.vision.patch_size
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), {
        "rl": RLTaskBatch(tokens=tok, position_id=jnp.abs(tok),
                          loss_mask=jnp.abs(tok), label=jnp.abs(tok),
                          images=jnp.zeros((1, 1, hw, hw, 3), jnp.float32))
    })["params"]
    return params, to_numpy(params)


def to_numpy(params):
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def port_model(params_np, decode_flash: str = "off", **model_overrides):
    """The port's db1_tiny (f32, CPU) holding the JAX weights."""
    pcfg = port_config.db1_tiny(dtype="float32", decode_flash=decode_flash,
                                **model_overrides)
    model = PortTXL(pcfg.model, pcfg.vocab, device="cpu")
    load_jax_params(model, params_np)
    return model


def fake_env_datasets(n_envs: int, obs_dim: int, act_dim: int,
                      episode_len: int, n_position: int = 64,
                      discrete: bool = False):
    """Tokenized FakeContinuousEnv (with ``discrete``: FakeDiscreteEnv of
    ``act_dim`` actions) instances in both packages, built from the same
    seeds: (jax_tenvs, port_tenvs)."""
    from bdm_db1_tpu.data import rl_dataset as jd
    from bdm_db1_tpu.eval import envs as je
    from bdm_db1_tpu.eval.wrapper import TokenizedEnv as JTenv
    from bdm_db1_tpu.tokenizers.scalar import ScalarTokenizer as JScalar
    from bdm_db1_tpu.tokenizers.text import ByteTextTokenizer
    from bdm_db1_tpu_torch.data import rl_dataset as td
    from bdm_db1_tpu_torch.eval import envs as te
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv as TTenv
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer as TScalar

    jcfg, tcfg = db1_tiny(), port_config.db1_tiny()
    env = "FakeDiscreteEnv" if discrete else "FakeContinuousEnv"
    kw = dict(obs_dim=obs_dim, episode_len=episode_len,
              **{"n_actions" if discrete else "act_dim": act_dim})
    jsuite = jd.RLTokenizerSuite(
        jcfg.vocab.layout(), JScalar(jcfg.vocab.num_continuous_bin),
        ByteTextTokenizer(), vision_patch_size=jcfg.vision.patch_size)
    tsuite = td.RLTokenizerSuite(
        tcfg.vocab.layout(), TScalar(tcfg.vocab.num_continuous_bin))
    jds = jd.RLFullDataset(
        "fake", jd.TrajectoryStore.from_flat_dataset(
            getattr(je, env)(seed=999, **kw).make_dataset(5)),
        jsuite, seq_length=n_position, use_prompt=True, seed=0)
    tds = td.RLFullDataset(
        "fake", td.TrajectoryStore.from_flat_dataset(
            getattr(te, env)(seed=999, **kw).make_dataset(5)),
        tsuite, seq_length=n_position, seed=0)
    jt = [JTenv(getattr(je, env)(seed=i, **kw), jds)
          for i in range(n_envs)]
    tt = [TTenv(getattr(te, env)(seed=i, **kw), tds)
          for i in range(n_envs)]
    return jt, tt


def image_env_datasets(kind: str, hw: int, n_envs: int = 2):
    """Tokenized image envs (``kind`` "discrete": FakeImageEnv,
    "continuous": FakeContinuousImageEnv) in both packages over the same
    seeded trajectories: (jax_tenvs, port_tenvs)."""
    from bdm_db1_tpu.data import rl_dataset as jd
    from bdm_db1_tpu.eval import envs as je
    from bdm_db1_tpu.eval.wrapper import TokenizedEnv as JTenv
    from bdm_db1_tpu.tokenizers.scalar import ScalarTokenizer as JScalar
    from bdm_db1_tpu_torch.data import rl_dataset as td
    from bdm_db1_tpu_torch.eval import envs as te
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv as TTenv
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer as TScalar

    cfg = db1_tiny()
    layout = cfg.vocab.layout()
    cls = {"discrete": "FakeImageEnv",
           "continuous": "FakeContinuousImageEnv"}[kind]
    out = []
    for envs, rd, scalar, tenv in ((je, jd, JScalar, JTenv),
                                   (te, td, TScalar, TTenv)):
        env_cls = getattr(envs, cls)
        ds = rd.RLFullDataset(
            "img", rd.TrajectoryStore.from_flat_dataset(
                env_cls(hw=hw, episode_len=10, seed=77).make_dataset(3)),
            rd.RLTokenizerSuite(layout, scalar(cfg.vocab.num_continuous_bin)),
            seq_length=cfg.model.n_position, seed=0)
        out.append([tenv(env_cls(hw=hw, seed=i), ds)
                    for i in range(n_envs)])
    return out


def image_primes(tenvs, n_steps: int, seed: int = 0):
    """Episode-start [prompt || obs || sep] primes with their frames, then
    random-frame [obs || sep] primes: [(tokens [B, q], frames [B, T, H, W,
    C])]."""
    rng = np.random.RandomState(seed)
    sep = np.full((len(tenvs), 1), tenvs[0].separator_id, np.int64)
    toks, frames = [], []
    for te in tenvs:
        prompt, pimg = te.get_prompt(strict_length=True, rng=rng)
        obs, img, _ = te.reset()
        toks.append(np.concatenate([prompt, obs, sep[0]]))
        frames.append(np.concatenate([pimg, img]))
    out = [(np.stack(toks), np.stack(frames))]
    shape = tenvs[0].observation_space.shape
    for _ in range(n_steps - 1):
        raws = [rng.rand(*shape).astype(np.float32) for _ in tenvs]
        obs, img = tenvs[0].encode_obs_batch(raws)
        out.append((np.concatenate([obs, sep], 1), img[:, None]))
    return out


def episode_primes(tenvs, seed: int, n_steps: int, obs_dim: int,
                   discrete: bool = False):
    """A fixed prime stream: the episode-start [prompt || obs || sep] of
    each env, then random-observation [obs || sep] primes (integers below
    8 with ``discrete``)."""
    rng = np.random.RandomState(seed)
    sep = np.array([tenvs[0].separator_id], dtype=np.int64)
    starts = []
    for te in tenvs:
        prompt, _ = te.get_prompt(strict_length=True, rng=rng)
        obs, _, _ = te.reset()
        starts.append(np.concatenate([prompt, obs, sep]))
    rs = np.random.RandomState(seed + 1)

    def rand_prime():
        raws = [rs.randint(0, 8, obs_dim) if discrete
                else rs.randn(obs_dim).astype(np.float32)
                for _ in range(len(tenvs))]
        obs_tok, _ = tenvs[0].encode_obs_batch(raws)
        return np.concatenate(
            [obs_tok, np.broadcast_to(sep, (len(tenvs), 1))], axis=1)

    return [np.stack(starts)] + [rand_prime() for _ in range(n_steps - 1)]


def greedy_chain(decoder, primes, defer: bool):
    """Action tokens of consecutive decode calls over one cache."""
    mems = decoder.init_mems(primes[0].shape[0])
    acts, deferred = [], None
    for p in primes:
        a, mems = decoder.decode(p, mems, deferred_tok=deferred,
                                 defer_last=defer)
        if defer:
            deferred = np.asarray(a)[..., -1]
        acts.append(np.asarray(a))
    return acts


def one_thread():
    """Keep the port's CPU ops on one thread (the suite runs under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return n
