"""The port's validation-loss path against the JAX package's, on the CPU:
the RL sample index and samples, the split and collate, the fused CE, the
full-sequence forward and trunk at db1_tiny (the port through K3's plain
route, JAX through ``rel_attention``), ``decode_rl`` greedy chains and
``evaluate_loss``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.core.config import db1_tiny as jax_db1_tiny
from bdm_db1_tpu.data import native as jn
from bdm_db1_tpu.data import rl_dataset as jd
from bdm_db1_tpu.data import samplers as js
from bdm_db1_tpu.data.input_specs import RLTaskBatch as JBatch
from bdm_db1_tpu.eval import envs as je
from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
from bdm_db1_tpu.models.transformer_xl import masked_cross_entropy as jmce
from bdm_db1_tpu.ops import fused_ce as jf
from bdm_db1_tpu.tokenizers.scalar import ScalarTokenizer as JScalar
from bdm_db1_tpu.tokenizers.text import ByteTextTokenizer
from bdm_db1_tpu.train import trainer as jt
from bdm_db1_tpu_torch.core import config as port_config
from bdm_db1_tpu_torch.data import native as tn
from bdm_db1_tpu_torch.data import rl_dataset as td
from bdm_db1_tpu_torch.data import samplers as ts
from bdm_db1_tpu_torch.data.input_specs import RLTaskBatch as TBatch
from bdm_db1_tpu_torch.eval import envs as te
from bdm_db1_tpu_torch.models.transformer_xl import masked_cross_entropy
from bdm_db1_tpu_torch.ops import flash_rel_attention as tk
from bdm_db1_tpu_torch.ops import fused_ce as tf
from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer as TScalar
from bdm_db1_tpu_torch.train import trainer as tt
from tests.torch_port_helpers import jax_tiny, one_thread, port_model

# logits: the ROADMAP bar (tests/test_parity.py) for f32 at db1_tiny
LOGIT_TOL = 2e-4
# losses and the fused CE: f32 sums of the same terms in another order
LOSS_TOL = 1e-6
# hidden states and memory after the tiny trunk (LayerNorm outputs ~1)
HID_TOL = 2e-4
SEQ = 1024   # n_position = seq_length: the kernel route's shapes


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _datasets(seq_length, n_episodes=6, episode_len=40, seed=0, **kw):
    """The same FakeContinuousEnv(5, 2) store in both packages."""
    env_kw = dict(obs_dim=5, act_dim=2, episode_len=episode_len)
    jcfg, tcfg = jax_db1_tiny(), port_config.db1_tiny()
    jsuite = jd.RLTokenizerSuite(
        jcfg.vocab.layout(), JScalar(jcfg.vocab.num_continuous_bin),
        ByteTextTokenizer(), vision_patch_size=jcfg.vision.patch_size)
    tsuite = td.RLTokenizerSuite(tcfg.vocab.layout(),
                                 TScalar(tcfg.vocab.num_continuous_bin))
    flat = je.FakeContinuousEnv(seed=999, **env_kw).make_dataset(n_episodes)
    tflat = te.FakeContinuousEnv(seed=999, **env_kw).make_dataset(n_episodes)
    jds = jd.RLFullDataset("fake", jd.TrajectoryStore.from_flat_dataset(flat),
                           jsuite, seq_length=seq_length, seed=seed, **kw)
    tds = td.RLFullDataset("fake", td.TrajectoryStore.from_flat_dataset(tflat),
                           tsuite, seq_length=seq_length, seed=seed, **kw)
    return jds, tds


# ---- data ------------------------------------------------------------------

def test_build_rl_sample_idx_matches_jax():
    lengths = [7, 1, 30, 12]
    for tn_ in (1, 5, 43):
        np.testing.assert_array_equal(tn.build_rl_sample_idx(lengths, tn_),
                                      jn.build_rl_sample_idx(lengths, tn_))


@pytest.mark.parametrize("kw", [
    {}, {"prompt_prob": 0.9, "prompt_strategy": "stochastic_timestep"},
    {"prompt_prob": 0.9, "prompt_at_final_transition_prob": 0.0},
    {"use_prompt": False}])
def test_rl_dataset_get_matches_jax(kw):
    jds, tds = _datasets(64, **kw)
    assert len(tds) == len(jds)
    np.testing.assert_array_equal(tds.indices, jds.indices)
    for i in list(range(0, len(jds), 7)) + [len(jds) - 1, len(jds) + 3]:
        a, b = jds.get(i), tds.get(i)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_split_and_collate_match_jax():
    jds, tds = _datasets(64)
    jsplit = jd.split_rl_dataset(jds, "90,5,5", seed=7)
    tsplit = td.split_rl_dataset(tds, "90,5,5", seed=7)
    for js_, ts_ in zip(jsplit, tsplit):
        np.testing.assert_array_equal(ts_.indices, js_.indices)
    jv, tv = jsplit[1], tsplit[1]
    jsam = iter(js.SequentialSampler(len(jv), 0, 3, 0, 1))
    tsam = iter(ts.SequentialSampler(len(tv), 0, 3, 0, 1))
    for _ in range(3):
        ji, ti = next(jsam), next(tsam)
        assert ji == ti
        jb = js.collate_modalities([jv[i] for i in ji], ["rl"])
        tb = ts.collate_modalities([tv[i] for i in ti], ["rl"])
        assert jb.keys() == tb.keys() and jb["rl"].keys() == tb["rl"].keys()
        for key in jb["rl"]:
            np.testing.assert_array_equal(tb["rl"][key], jb["rl"][key])


# ---- loss ------------------------------------------------------------------

def test_fused_ce_matches_jax():
    rng = np.random.RandomState(0)
    h = rng.randn(2, 16, 32).astype(np.float32)
    emb = (rng.randn(640, 32) * 0.5).astype(np.float32)
    labels = rng.randint(0, 600, (2, 16)).astype(np.int32)
    mask = (rng.rand(2, 16) < 0.6).astype(np.float32)
    th, temb = torch.from_numpy(h), torch.from_numpy(emb)
    tl, tm = torch.from_numpy(labels), torch.from_numpy(mask)
    jh, jemb, jl, jm = (jnp.asarray(x) for x in (h, emb, labels, mask))
    ref = float(jf.masked_cross_entropy_fused(jh, jemb, jl, jm, 600))
    assert abs(float(tf.masked_cross_entropy_fused(th, temb, tl, tm, 600))
               - ref) <= LOSS_TOL
    for block in (128, 320):   # several vocab chunks
        got = float(tf.masked_ce_tied(th, temb, tl, tm, 600, block))
        assert abs(got - ref) <= LOSS_TOL, block
    logits = jnp.einsum("bld,vd->blv", jh, jemb)
    ref_plain = float(jmce(logits, jl, jm, 600))
    got_plain = float(masked_cross_entropy(
        torch.from_numpy(np.array(logits)), tl, tm, 600))
    assert abs(got_plain - ref_plain) <= LOSS_TOL
    assert abs(ref_plain - ref) <= LOSS_TOL
    assert tf._pick_block(33152) == jf._pick_block(33152) == 4736


# ---- model -----------------------------------------------------------------

def _models(mem_len):
    """JAX db1_tiny (f32, "xla") and the port's copy (K3's route)."""
    over = dict(n_position=SEQ, mem_len=mem_len)
    cfg, jm, params, pnp = jax_tiny(attention_impl="xla", **over)
    tm = port_model(pnp, attention_impl="pallas", **over)
    return cfg, jm, params, tm


def _batch(tds, idx):
    raw = ts.collate_modalities([tds.get(i) for i in idx], ["rl"])["rl"]
    jb = {"rl": JBatch(**{k: jnp.asarray(v) for k, v in raw.items()})}
    tb = {"rl": TBatch(**{k: torch.from_numpy(v) for k, v in raw.items()})}
    return jb, tb


@pytest.mark.parametrize("mem_len", [32, 1024])
def test_forward_matches_jax(mem_len):
    """Logits and losses at seq 1024 (same_length on): with mem_len 32 the
    window is active; with mem_len 1024 (db1_1p2b's) the mask is purely
    causal."""
    cfg, jm, params, tm = _models(mem_len)
    assert tk.kernel_route_applicable(SEQ, SEQ)
    _, tds = _datasets(SEQ, n_episodes=3, episode_len=200)
    jb, tb = _batch(tds, [0, 77])
    logits_j, loss_j = jax.jit(lambda p, b: jm.apply({"params": p}, b))(
        params, jb)
    calls = []
    real = tk.flash_rel_attention_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    tk.flash_rel_attention_plain = spy
    try:
        with torch.no_grad():   # forward follows the caller's grad mode
            logits_t, loss_t = tm(tb)
            _, loss_only = tm(tb, loss_only=True)
    finally:
        tk.flash_rel_attention_plain = real
    assert len(calls) == 2 * cfg.model.n_layer   # K3's route, every layer
    lj = np.asarray(logits_j)
    err = np.abs(logits_t.numpy() - lj).max() / np.abs(lj).max()
    assert err <= LOGIT_TOL, err
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_TOL
    _, loss_only_j = jax.jit(lambda p, b: jm.apply(
        {"params": p}, b, loss_only=True))(params, jb)
    assert abs(float(loss_only) - float(loss_only_j)) <= LOSS_TOL
    assert abs(float(loss_only) - float(loss_t)) <= LOSS_TOL


def test_trunk_with_mems_matches_jax():
    cfg, jm, params, tm = _models(512)
    rng = np.random.RandomState(3)
    L, B, D = cfg.model.n_layer, 2, cfg.model.n_embed
    h = rng.randn(B, 64, D).astype(np.float32)
    mems = rng.randn(L, B, 512, D).astype(np.float32)
    out_j, new_j = jax.jit(lambda p, h, m: jm.apply(
        {"params": p}, h, m, True, method=JaxTXL.trunk))(params, h, mems)
    with torch.no_grad():
        out_t, new_t = tm.trunk(torch.from_numpy(h), torch.from_numpy(mems))
    assert new_t.shape == (L, B, 512, D)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=HID_TOL)
    np.testing.assert_allclose(new_t.numpy(), np.asarray(new_j), rtol=0,
                               atol=HID_TOL)


def test_decode_rl_greedy_chains_match_jax():
    """decode_rl over hidden-state memory (mem_len 512): each step primes
    64 tokens (K3's route in the port) and then decodes two action tokens
    one at a time (rel_attention); the argmax chains must be equal."""
    cfg, jm, params, tm = _models(512)
    layout = cfg.vocab.layout()
    bias = layout.continuous_action_logit_bias()
    rng = np.random.RandomState(5)
    B = 2
    step = jax.jit(lambda p, t, pos, m: jm.apply(
        {"params": p}, t, pos, m, method=JaxTXL.decode_rl))
    mems_j = jm.apply({"params": params}, B, method=JaxTXL.init_mems)
    mems_t = tm.init_mems(B)
    assert mems_t.shape == mems_j.shape
    chains_j, chains_t = [], []
    for s in range(3):
        prime = rng.randint(layout.continuous_offset, layout.separator_id,
                            (B, 64))
        prime[:, -1] = layout.separator_id
        pos = np.broadcast_to(np.arange(1, 65), (B, 64)).copy()
        for chain, run in ((chains_j, "j"), (chains_t, "t")):
            cur, cpos = prime, pos
            for a in range(3):
                if run == "j":
                    lg, mems_j = step(params, jnp.asarray(cur),
                                      jnp.asarray(cpos), mems_j)
                    lg = np.asarray(lg)
                else:
                    lg, mems_t = tm.decode_rl(torch.from_numpy(cur),
                                              torch.from_numpy(cpos), mems_t)
                    lg = lg.numpy()
                tok = np.argmax(lg + bias, -1)
                chain.append(tok)
                cur, cpos = tok[:, None], np.zeros((B, 1), np.int64)
    np.testing.assert_array_equal(np.stack(chains_t), np.stack(chains_j))
    np.testing.assert_allclose(mems_t.numpy(), np.asarray(mems_j), rtol=0,
                               atol=HID_TOL)


def test_evaluate_loss_matches_jax():
    cfg, jm, params, tm = _models(1024)
    _, tds = _datasets(SEQ, n_episodes=3, episode_len=200)
    _, valid, _ = td.split_rl_dataset(tds, "50,50,0", seed=3)
    sam = iter(ts.SequentialSampler(len(valid), 0, 2, 0, 1))
    batches = []
    for _ in range(2):   # two loader batches of [accum 2, micro 2]
        micro = [ts.collate_modalities([valid[i] for i in next(sam)], ["rl"])
                 for _ in range(2)]
        batches.append({"rl": {k: np.stack([m["rl"][k] for m in micro])
                               for k in micro[0]["rl"]}})
    ref = jt.evaluate_loss(jm, types.SimpleNamespace(params=params), batches)
    got = tt.evaluate_loss(tm, batches, device="cpu")
    assert np.isfinite(got) and abs(got - ref) <= LOSS_TOL, (got, ref)


def test_evaluate_loss_needs_its_device():
    _, _, _, tm = _models(32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tt.evaluate_loss(tm, [], device="cuda")
    assert np.isnan(tt.evaluate_loss(tm, [], device="cpu"))


def test_unported_paths_raise():
    _, _, _, tm = _models(32)
    tok = torch.zeros(1, 8, dtype=torch.long)
    rl = TBatch(tokens=tok, position_id=tok, loss_mask=tok.float(), label=tok)
    # dropout is ported (tests/test_torch_train_step.py); remat is not
    tm.cfg.remat = True
    try:
        with pytest.raises(NotImplementedError, match="remat"):
            tm.trunk(torch.zeros(1, 8, 64), None, deterministic=False)
    finally:
        tm.cfg.remat = False
    with pytest.raises(ValueError, match="unknown modality"):
        tm({"rl": rl, "audio": rl})
    with pytest.raises(NotImplementedError):
        tm({"nlp": rl})
