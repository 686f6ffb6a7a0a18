"""Pre-LN models in the port against the JAX package, on the CPU at db1_tiny
in f32: the logits without memory (through ``rel_attention`` and through
K3's plain route), the geglu + pre-LN + memory carry of ``decode_rl``, the
hidden-state ``ActionDecoder`` chains (continuous, discrete, an image env,
int8 weights), ``evaluate_rl.main``'s records (lockstep and one episode at
a time),
and the refusals: ``mem_len`` 0 in the decoder, the K/V caches and the
generators for pre-LN.

Every LayerNorm scale and bias of the trunk is drawn away from (1, 0), so
LN(0) is not 0 and a zero K/V cache is not a zero hidden memory."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    episode_primes, fake_env_datasets, image_env_datasets, image_primes,
    jax_tiny, one_thread, port_model,
)

OBS, ACT = 4, 2
# logits and hidden memory: the ROADMAP bar (tests/test_parity.py) for f32
# at db1_tiny, max |diff| at most LOGIT_TOL * max |logit|
LOGIT_TOL = 2e-4
MEM_TOL = 2e-4
TAG = "db1_tiny_preln"


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _perturbed(pnp, seed: int = 0):
    """The numpy param tree with every trunk LayerNorm scale drawn around 1
    and bias around 0."""
    rng = np.random.RandomState(seed)
    out = jax.tree.map(np.array, pnp)
    for sub in ("attn", "ff"):
        ln = out["layers"][sub]["layer_norm"]
        ln["scale"] = (1 + 0.3 * rng.randn(*ln["scale"].shape)).astype(
            np.float32)
        ln["bias"] = (0.3 * rng.randn(*ln["bias"].shape)).astype(np.float32)
    return out


def _preln(flash="off", vision=False, **over):
    """(JAX cfg, JAX model, perturbed params, port model) of a pre-LN
    db1_tiny holding the same weights: a fresh JAX pre-LN init, or with
    ``vision`` the shared image-RL init."""
    cfg, jm, _, pnp = jax_tiny(flash, vision=vision, pre_lnorm=True, **over) \
        if vision else _jax_preln(flash, **over)
    pnp = _perturbed(pnp) if vision else _fresh_preln_params()
    return cfg, jm, pnp, port_model(pnp, flash, pre_lnorm=True, **over)


def _jax_preln(flash, **over):
    """jax_tiny's (cfg, model) for pre-LN without its shared init."""
    from bdm_db1_tpu.core.config import db1_tiny
    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL

    cfg = db1_tiny()
    cfg.model.dtype = "float32"
    cfg.model.decode_flash = flash
    cfg.model.pre_lnorm = True
    for key, val in over.items():
        setattr(cfg.model, key, val)
    return cfg, JaxTXL(cfg.model, cfg.vocab, cfg.vision), None, None


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _fresh_preln_params():
    """A fresh JAX init of a pre-LN db1_tiny (jitted), LayerNorms
    perturbed, as numpy."""
    from bdm_db1_tpu.core.config import db1_tiny
    from bdm_db1_tpu.data.input_specs import RLTaskBatch as JBatch
    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
    from torch_port_helpers import to_numpy

    cfg = db1_tiny()
    cfg.model.dtype = "float32"
    cfg.model.pre_lnorm = True
    jm = JaxTXL(cfg.model, cfg.vocab, cfg.vision)
    tok = jnp.zeros((1, cfg.model.n_position), jnp.int32)
    params = jax.jit(lambda b: jm.init(jax.random.PRNGKey(1), b,
                                       compute_loss=False))(
        {"rl": JBatch(tokens=tok, position_id=tok)})["params"]
    return _perturbed(to_numpy(params), seed=1)


@pytest.mark.parametrize("impl,seq", [("xla", 64), ("pallas", 1024)])
def test_preln_logits_match_jax(impl, seq):
    """A pre-LN forward without memory: the JAX model through
    ``rel_attention``, the port through ``rel_attention`` (seq 64) and
    through K3's plain route (seq 1024, the kernel gate's shape). The
    weights of a fresh JAX pre-LN init load into the port with
    ``strict=True`` (a pre-LN layer has the post-LN parameter names)."""
    from bdm_db1_tpu.core.config import db1_tiny
    from bdm_db1_tpu.data.input_specs import RLTaskBatch as JBatch
    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
    from bdm_db1_tpu_torch.core import config as tcfg
    from bdm_db1_tpu_torch.data.input_specs import RLTaskBatch as TBatch
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.train.convert import state_dict_from_jax

    cfg = db1_tiny()
    cfg.model.dtype = "float32"
    cfg.model.pre_lnorm = True
    cfg.model.n_position = seq
    jm = JaxTXL(cfg.model, cfg.vocab, cfg.vision)
    rng = np.random.RandomState(3)
    V = cfg.vocab.layout().total_vocab_size
    tok = rng.randint(0, V, (2, seq))
    pos = rng.randint(0, 8, (2, seq))
    pnp = _fresh_preln_params()
    want = np.asarray(jax.jit(lambda p, b: jm.apply(
        {"params": p}, b, compute_loss=False)[0])(pnp, {"rl": JBatch(
            tokens=jnp.asarray(tok), position_id=jnp.asarray(pos))}))
    pc = tcfg.db1_tiny(dtype="float32", pre_lnorm=True, n_position=seq,
                       attention_impl=impl)
    tm = TransformerXL(pc.model, pc.vocab, device="cpu")
    sd, _ = state_dict_from_jax(pnp, tcfg.DB1Config(model=pc.model,
                                                    vocab=pc.vocab))
    own = tm.state_dict()
    # the tree has no vision subtree: the tower keeps its init
    tm.load_state_dict({**{k: v for k, v in own.items()
                           if k.startswith("vision_encoder.")}, **sd},
                       strict=True)
    with torch.no_grad():
        got, _ = tm({"rl": TBatch(tokens=torch.from_numpy(tok),
                                  position_id=torch.from_numpy(pos))},
                    compute_loss=False)
    assert got.shape == want.shape
    assert _rel(got[..., :V].numpy(), want[..., :V]) <= LOGIT_TOL


def test_geglu_preln_memory_carry_matches_jax():
    """JAX's test_geglu_prelnorm_memory_parity against ``decode_rl``: three
    forwards of q = 5, 1, 3 carrying the hidden memory; the logits and the
    new memory of each."""
    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL

    cfg, jm, pnp, tm = _preln()
    assert cfg.model.activation_fn == "geglu"
    V = cfg.vocab.layout().total_vocab_size
    rng = np.random.RandomState(5)
    jmem = jm.apply({"params": pnp}, 1, method=JaxTXL.init_mems)
    tmem = tm.init_mems(1)
    step = jax.jit(lambda p, t, q, m: jm.apply(
        {"params": p}, t, q, m, method=JaxTXL.decode_rl))
    for qlen in (5, 1, 3):
        tok = rng.randint(0, V, (1, qlen))
        pos = rng.randint(0, 8, (1, qlen))
        jl, jmem = step(pnp, jnp.asarray(tok), jnp.asarray(pos), jmem)
        tl, tmem = tm.decode_rl(torch.from_numpy(tok), torch.from_numpy(pos),
                                tmem)
        assert _rel(tl[:, :V].numpy(), np.asarray(jl)[:, :V]) <= LOGIT_TOL
        assert tmem.shape == jmem.shape == (2, 1, 32, 64)
        np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), rtol=0,
                                   atol=MEM_TOL)


def _chain(decoder, primes):
    """Action tokens of consecutive decode calls over one memory (primes
    [(tokens, frames or None)])."""
    mems = decoder.init_mems(primes[0][0].shape[0])
    acts = []
    for tok, img in primes:
        a, mems = decoder.decode(tok, mems, prime_images=img)
        acts.append(np.asarray(a))
    return acts, mems


@pytest.mark.parametrize("case", ["continuous", "discrete", "image", "int8"])
def test_hidden_state_chains_match_jax(case):
    """Four env steps over hidden-state memory: the episode-start prime
    (longer than mem_len 32) in one ``decode_rl`` forward, then [obs ||
    sep] primes; every action dim one forward. The decoder neither defers,
    buckets nor chunks; the chains equal the JAX decoder's exactly."""
    from bdm_db1_tpu.eval.decode import build_decoder_for_env as jbuild
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env as tbuild

    over = {"decode_weight_dtype": "int8"} if case == "int8" else {}
    cfg, jm, pnp, tm = _preln(vision=case == "image", **over)
    if case == "image":
        jt, tt = image_env_datasets("discrete", 32)
        primes = image_primes(jt, 4)
        for (a, fa), (b, fb) in zip(primes, image_primes(tt, 4)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(fa, fb)
    else:
        discrete = case == "discrete"
        jt, tt = fake_env_datasets(3, OBS, ACT, episode_len=6,
                                   discrete=discrete)
        primes = [(p, None) for p in episode_primes(jt, 0, 4, OBS,
                                                     discrete=discrete)]
    tdec = tbuild(tm, tt[0], pad_buckets="default")
    assert not (tdec.use_kv_cache or tdec.defers or tdec.speculates)
    assert tdec.pad_buckets is None
    assert tdec.chunk_plan(primes[0][0].shape[1], 0) == (None, None)
    assert primes[0][0].shape[1] > cfg.model.mem_len
    assert tm.decode_weights_quantized() == (case == "int8")
    want, jmem = _chain(jbuild(jm, pnp, jt[0]), primes)
    got, tmem = _chain(tdec, primes)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {i}")
    assert tmem.shape == jmem.shape
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), rtol=0,
                               atol=MEM_TOL)


@pytest.mark.parametrize("batched", [True, False])
def test_preln_evaluate_rl_main_matches_jax(batched, tmp_path):
    """``evaluate_rl.main`` on a pre-LN db1_tiny from a DeepSpeed checkpoint
    of the perturbed weights, at the default geometry buckets (which the
    hidden-state decoder does not take), 2 trials: in one lockstep cohort
    of 2 (``evaluate_envs_lockstep``) and one episode at a time
    (``run_episode``). The JAX driver's records and results lines."""
    from bdm_db1_tpu.core.config import db1_tiny as jdb1_tiny
    from bdm_db1_tpu.data import rl_dataset as jd
    from bdm_db1_tpu.eval import envs as je
    from bdm_db1_tpu.eval.evaluate_rl import main as jmain
    from bdm_db1_tpu.train.convert import save_deepspeed_checkpoint
    from bdm_db1_tpu_torch.core import config as tcfg
    from bdm_db1_tpu_torch.eval import evaluate_rl as ter

    jcfg, _, pnp, _ = _preln()
    jd.TrajectoryStore.from_flat_dataset(je.FakeContinuousEnv(
        episode_len=8).make_dataset(5)).save_cache(str(tmp_path / "rl"),
                                                   "fake-continuous-v0")
    save_deepspeed_checkpoint(pnp, jcfg, str(tmp_path / "ckpt"), TAG,
                              dtype="float32")
    cfgs = []
    for mk in (jdb1_tiny, tcfg.db1_tiny):
        cfg = mk()
        cfg.model.dtype = "float32"
        cfg.model.pre_lnorm = True
        cfg.data.rl_dataset_cache_dir = str(tmp_path / "rl")
        cfg.data.seq_length = cfg.model.n_position
        cfg.train.load_dir, cfg.train.ckpt_tag = str(tmp_path / "ckpt"), TAG
        cfg.eval = dataclasses.replace(
            cfg.eval, env_names=("fake-continuous-v0",), num_trials=2,
            max_step_size=3, batch_size=2, batched=batched)
        assert cfg.eval.decode_obs_buckets
        cfgs.append(cfg)
    cfgs[0].train.save_dir = str(tmp_path / "jax")
    cfgs[1].train.save_dir = str(tmp_path / "port")
    want = jmain(cfgs[0])
    got = ter.main(cfgs[1], device="cpu")
    assert got == want and len(got) == 1
    assert np.isfinite(got[0]["return_mean"])
    lines = {k: (tmp_path / k / "results.output").read_text().splitlines()
             for k in ("jax", "port")}
    assert lines["port"] == lines["jax"]


def test_mem_len_zero_is_refused_as_in_jax():
    """At mem_len 0 the trunk keeps the whole [memory || input] as the next
    memory: the JAX decoder's action scan fails on the growing carry with
    a TypeError; the port refuses the decoder with a ValueError that names
    the stateless path."""
    from bdm_db1_tpu.eval.decode import build_decoder_for_env as jbuild
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env as tbuild

    over = dict(mem_len=0, same_length=False)
    _, jm, _, _ = _jax_preln("off", pre_lnorm=False, **over)
    pnp = _fresh_preln_params()
    jt, tt = fake_env_datasets(1, OBS, ACT, episode_len=4)
    prime = episode_primes(jt, 0, 1, OBS)[0]
    jdec = jbuild(jm, pnp, jt[0])
    with pytest.raises(TypeError, match="carry"):
        jdec.decode(prime, jdec.init_mems(1))
    with pytest.raises(ValueError, match="WindowDecoder"):
        tbuild(port_model(pnp, **over), tt[0])


def test_kv_caches_and_generators_refuse_preln():
    """The zero K/V cache is a pre-LN model's zero memory only when LN(0)
    is 0: the ring and aligned caches and the text generator refuse pre-LN
    (the JAX package asserts the same)."""
    from bdm_db1_tpu.eval.generate import TextGenerator as JGen
    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
    from bdm_db1_tpu_torch.eval.generate import TextGenerator

    cfg, jm, pnp, tm = _preln()
    for method in (JaxTXL.init_kv_cache_ring, JaxTXL.init_kv_cache):
        with pytest.raises(AssertionError, match="post-LN"):
            jm.apply({"params": pnp}, 1, method=method)
    with pytest.raises(AssertionError, match="post-LN"):
        JGen(jm, pnp, cfg.vocab.layout(), 0)
    for fn in (tm.init_kv_cache_ring, tm.init_kv_cache):
        with pytest.raises(ValueError, match="post-LN"):
            fn(1)
    with pytest.raises(ValueError, match="post-LN"):
        TextGenerator(tm, tm.layout, 0)
