"""Geometry buckets in the port against the JAX package's (db1_tiny, f32,
CPU, same weights): the ladder, ``decode_rl_kv_ring(real_q=...)`` on a
padded prime that wraps the ring (logits, committed rows, untouched pad
slots, cursor), greedy chains of bucketed decoders equal to the port's
unpadded chains and to the JAX package's bucketed ones (with and without
defer, the kernel route's plain versions and the plain ring branch, an
int8 cache, a discrete env with an action mask), one positional
projection a bucket across observation lengths in a ``DecoderPool``, and
the suite census (tests/test_geometry_buckets.py through the port)."""

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    episode_primes, fake_env_datasets, greedy_chain, jax_tiny, one_thread,
    port_model,
)

OBS, ACT = 4, 2
# decode_rl_kv_ring against the JAX package's (f32): logits relative to the
# largest JAX logit, the committed rows absolute (tests/test_parity.py's bar)
LOGIT_TOL = 2e-4
ROW_TOL = 2e-4


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def test_bucket_for_matches_jax():
    from bdm_db1_tpu.eval.decode import DEFAULT_OBS_BUCKETS as JB
    from bdm_db1_tpu.eval.decode import _bucket_for as jb
    from bdm_db1_tpu_torch.eval.decode import DEFAULT_OBS_BUCKETS, _bucket_for

    assert DEFAULT_OBS_BUCKETS == JB
    assert _bucket_for(6, DEFAULT_OBS_BUCKETS) == 8
    assert _bucket_for(8, DEFAULT_OBS_BUCKETS) == 8
    assert _bucket_for(25, DEFAULT_OBS_BUCKETS) == 32
    assert _bucket_for(300, DEFAULT_OBS_BUCKETS) is None
    for w in range(0, 300):
        assert _bucket_for(w, DEFAULT_OBS_BUCKETS) == jb(w, JB), w


def _ring_cache(rng, c, B, cursor, int8):
    """A seeded ring cache in both packages' layouts: (jax dict, port
    dict). int8: values and scales quantized by the port's
    quantize_kv_rows, the same arrays on both sides."""
    import jax.numpy as jnp

    from bdm_db1_tpu_torch.models.transformer_xl import quantize_kv_rows

    shape = (c.n_layer, B, c.mem_len, c.n_head, c.d_head)
    kv = {k: torch.from_numpy(rng.randn(*shape).astype(np.float32))
          for k in "kv"}
    if int8:
        for k in "kv":
            kv[k], kv[k + "_scale"] = quantize_kv_rows(kv[k])
    jcache = {k: jnp.asarray(v.numpy()) for k, v in kv.items()}
    jcache["cursor"] = jnp.asarray(cursor, jnp.int32)
    return jcache, {**{k: v.clone() for k, v in kv.items()}, "cursor": cursor}


@pytest.mark.parametrize("cursor,real_q,int8,flash", [
    (28, 3, False, "off"),     # cursor + W > M, cursor + real_q <= M
    (28, 6, False, "on"),      # the real rows themselves wrap
    (29, 5, True, "on"),       # int8 cache, wrapping real rows
    (30, 2, True, "off")])    # the real rows end at slot M - 1
def test_padded_ring_forward_matches_jax(cursor, real_q, int8, flash):
    """An 8-row ring forward with real_q real rows at a cursor where the
    padded range wraps past slot M - 1: logits from the last real row and
    the committed rows within the bars of JAX's masked commit, the slots
    the pads point at (the oldest rows) left exactly as they were, the
    cursor advanced by real_q; and equal to the port's unpadded call."""
    import jax

    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL

    over = dict(decode_cache_dtype="int8") if int8 else {}
    cfg, jm, params, pnp = jax_tiny("off", **over)
    tm = port_model(pnp, flash, **over)
    c = cfg.model
    B, W, M = 2, 8, c.mem_len
    assert cursor + W > M
    rng = np.random.RandomState(cursor + real_q)
    tok = np.zeros((B, W), np.int64)
    tok[:, :real_q] = rng.randint(0, cfg.vocab.layout().total_vocab_size,
                                  (B, real_q))
    pos = np.zeros((B, W), np.int64)
    pos[:, :real_q] = rng.randint(0, 20, (B, real_q))
    jcache, tcache = _ring_cache(rng, c, B, cursor, int8)
    before = {k: v.clone() for k, v in tcache.items() if k != "cursor"}
    ucache = {**{k: v.clone() for k, v in before.items()}, "cursor": cursor}

    lj, nj = jax.jit(lambda p, t, s, cch: jm.apply(
        {"params": p}, t, s, cch,
        jm.apply({"params": p}, W, method=JaxTXL.precompute_rk),
        real_q=jax.numpy.int32(real_q),
        method=JaxTXL.decode_rl_kv_ring))(params, tok, pos, jcache)
    lt, nt = tm.decode_rl_kv_ring(torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcache,
                                  tm.precompute_rk(W), real_q=real_q)
    lj = np.asarray(lj)
    assert np.abs(lt.numpy() - lj).max() <= LOGIT_TOL * np.abs(lj).max()
    assert nt["cursor"] == int(nj["cursor"]) == (cursor + real_q) % M
    slots = [(cursor + t) % M for t in range(real_q)]
    rest = [s for s in range(M) if s not in slots]
    for key, old in before.items():
        got = nt[key]
        assert torch.equal(got[:, :, rest], old[:, :, rest]), key
        want = np.asarray(nj[key])[:, :, slots]
        if key in ("k", "v") and int8:
            # one int8 step at most where the f32 rows round apart
            d = np.abs(got[:, :, slots].numpy().astype(np.int32)
                       - want.astype(np.int32))
            assert d.max() <= 1, key
        else:
            np.testing.assert_allclose(got[:, :, slots].numpy(), want,
                                       rtol=0, atol=ROW_TOL, err_msg=key)
    # the unpadded call from the same cache: the same logits and rows
    lu, nu = tm.decode_rl_kv_ring(
        torch.from_numpy(tok[:, :real_q]), torch.from_numpy(pos[:, :real_q]),
        ucache, tm.precompute_rk(real_q))
    torch.testing.assert_close(lt, lu, rtol=0, atol=1e-5)
    assert nu["cursor"] == nt["cursor"]
    for key in before:
        torch.testing.assert_close(nt[key], nu[key], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def envs():
    return fake_env_datasets(3, OBS, ACT, episode_len=8)


@pytest.mark.parametrize("flash,defer,int8", [
    ("off", True, False), ("on", True, False), ("off", False, False),
    ("on", False, False), ("off", True, True), ("on", True, True)])
def test_bucketed_chains_match_jax(envs, flash, defer, int8):
    """Five env steps at batch 3: the episode-start prime in 32-token ring
    slices (the last padded to its bucket), then [deferred || obs || sep]
    (6 -> 8) or [obs || sep] (5 -> 8) primes. The port's bucketed chain
    equals its unpadded chain and the JAX package's bucketed chain."""
    from bdm_db1_tpu.eval.decode import build_decoder_for_env as jbuild
    from bdm_db1_tpu_torch.eval.decode import (
        DEFAULT_OBS_BUCKETS, build_decoder_for_env as tbuild,
    )

    over = dict(decode_cache_dtype="int8") if int8 else {}
    cfg, jm, params, pnp = jax_tiny("off", **over)
    jt, tt = envs
    primes = episode_primes(jt, 1, 5, OBS)
    np.testing.assert_array_equal(primes[1], episode_primes(tt, 1, 5, OBS)[1])
    want = greedy_chain(jbuild(jm, params, jt[0], pad_buckets="default"),
                        primes, defer)
    tm = port_model(pnp, flash, **over)
    dec = tbuild(tm, tt[0], pad_buckets="default")
    assert dec.pad_buckets == DEFAULT_OBS_BUCKETS
    lead = 1 if defer else 0
    widths, _, real = dec.prime_plan(primes[1].shape[1] + lead, lead)
    assert (widths, real) == ([8], OBS + 1 + lead)
    widths, _, real = dec.prime_plan(primes[0].shape[1], 0)
    assert len(widths) > 1 and real is not None and widths[-1] > real
    got = greedy_chain(dec, primes, defer)
    ref = greedy_chain(tbuild(tm, tt[0]), primes, defer)
    for i, (w, g, r) in enumerate(zip(want, got, ref)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {i}")
        np.testing.assert_array_equal(r, w, err_msg=f"unpadded step {i}")


def _discrete_envs(n_envs, obs_dim, n_actions, episode_len):
    """Tokenized FakeDiscreteEnv instances in both packages over the same
    seeded trajectories: (jax_tenvs, port_tenvs)."""
    from bdm_db1_tpu.core.config import db1_tiny
    from bdm_db1_tpu.data import rl_dataset as jd
    from bdm_db1_tpu.eval import envs as je
    from bdm_db1_tpu.eval.wrapper import TokenizedEnv as JTenv
    from bdm_db1_tpu.tokenizers.scalar import ScalarTokenizer as JScalar
    from bdm_db1_tpu_torch.data import rl_dataset as td
    from bdm_db1_tpu_torch.eval import envs as te
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv as TTenv
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer as TScalar

    cfg = db1_tiny()
    kw = dict(obs_dim=obs_dim, n_actions=n_actions, episode_len=episode_len)
    out = []
    for envs, rd, scalar, tenv in ((je, jd, JScalar, JTenv),
                                   (te, td, TScalar, TTenv)):
        ds = rd.RLFullDataset(
            "fake-discrete", rd.TrajectoryStore.from_flat_dataset(
                envs.FakeDiscreteEnv(seed=999, **kw).make_dataset(5)),
            rd.RLTokenizerSuite(cfg.vocab.layout(),
                                scalar(cfg.vocab.num_continuous_bin)),
            seq_length=cfg.model.n_position, seed=0)
        out.append([tenv(envs.FakeDiscreteEnv(seed=i, **kw), ds)
                    for i in range(n_envs)])
    return out


def test_bucketed_discrete_env_with_mask():
    """A discrete geometry (obs 5, 4 actions) with a per-row action mask:
    the bucketed chain equals the unpadded one and the JAX package's."""
    from bdm_db1_tpu.eval.decode import build_decoder_for_env as jbuild
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env as tbuild

    cfg, jm, params, pnp = jax_tiny("off")
    jt, tt = _discrete_envs(2, 5, 4, 8)
    rng = np.random.RandomState(0)
    sep = np.array([jt[0].separator_id], dtype=np.int64)
    starts = []
    for te in jt:
        prompt, _ = te.get_prompt(strict_length=True, rng=rng)
        obs, _, _ = te.reset()
        starts.append(np.concatenate([prompt, obs, sep]))
    primes = [np.stack(starts)]
    for _ in range(5):
        raws = [rng.randint(0, 8, 5).astype(np.int64) for _ in jt]
        obs_tok, _ = jt[0].encode_obs_batch(raws)
        np.testing.assert_array_equal(obs_tok, tt[0].encode_obs_batch(raws)[0])
        primes.append(np.concatenate(
            [obs_tok, np.broadcast_to(sep, (2, 1))], axis=1))
    mask = np.array([[1, 1, 0, 1], [0, 1, 1, 1]], np.float32)

    def chain(dec):
        mems = dec.init_mems(2)
        acts = []
        for p in primes:
            a, mems = dec.decode(p, mems, env_action_mask=mask)
            acts.append(np.asarray(a))
        return acts

    want = chain(jbuild(jm, params, jt[0], pad_buckets="default"))
    tm = port_model(pnp, "on")
    got = chain(tbuild(tm, tt[0], pad_buckets="default"))
    ref = chain(tbuild(tm, tt[0]))
    for i, (w, g, r) in enumerate(zip(want, got, ref)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {i}")
        np.testing.assert_array_equal(r, w, err_msg=f"unpadded step {i}")


def test_pool_shares_one_projection_a_bucket():
    """Two geometries (obs 4 and 5) in one bucketed pool: separate
    decoders, one RkCache, and their steady primes (5 and 6 tokens) both
    padded to 8: the pool holds the q == 1 projection and the width 8
    only; unbucketed, it holds both exact widths."""
    from bdm_db1_tpu_torch.eval.decode import DecoderPool

    _, _, _, pnp = jax_tiny("off")
    tm = port_model(pnp, "off")
    t4 = fake_env_datasets(1, 4, ACT, episode_len=6)[1][0]
    t5 = fake_env_datasets(1, 5, ACT, episode_len=6)[1][0]
    for buckets, widths in (("default", [1, 8]), (None, [1, 5, 6])):
        pool = DecoderPool(tm, pad_buckets=buckets)
        dec4, dec5 = pool.get(t4), pool.get(t5)
        assert dec4 is not dec5 and dec4._rk is dec5._rk is pool.rk_cache
        for tenv, dec in ((t4, dec4), (t5, dec5)):
            obs, _, _ = tenv.reset()
            prime = np.concatenate([obs, [tenv.separator_id]])[None]
            dec.decode(prime, dec.init_mems(1))
        assert sorted(pool.rk_cache.widths()) == widths, buckets


def test_rk_cache_keeps_the_step_projection():
    """The q == 1 projection stays however many prime widths pass through
    the LRU (the ladder's ten and more)."""
    from bdm_db1_tpu_torch.eval.decode import DEFAULT_OBS_BUCKETS, RkCache

    _, _, _, pnp = jax_tiny("off")
    tm = port_model(pnp, "off")
    rk = RkCache(tm, cap=3)
    step = rk.get(1)
    for w in DEFAULT_OBS_BUCKETS[:6]:
        rk.get(w)
    assert rk.get(1) is step
    assert rk.widths() == [1, 32, 48, 64]


@pytest.mark.parametrize("kw", [
    dict(), dict(buckets=None), dict(defers=False),
    dict(suites=("dmc", "atari")), dict(buckets=(8, 32, 128))])
def test_census_matches_jax(kw):
    from bdm_db1_tpu.eval import geometry_census as jgc
    from bdm_db1_tpu_torch.eval import geometry_census as tgc

    assert tgc.census(**kw) == jgc.census(**kw)
    rep = tgc.census(**kw)
    if not kw:
        assert rep["n_envs"] > 200
        assert rep["programs_bucketed"] <= 25 < rep["programs_exact"]
    if kw == dict(buckets=None):
        assert rep["programs_bucketed"] == rep["programs_exact"]
    assert [_fields(f) for f in tgc.SUITE_GEOMETRIES] == [
        _fields(f) for f in jgc.SUITE_GEOMETRIES]


def _fields(f):
    import dataclasses

    return dataclasses.astuple(f) + (tuple(f.obs_widths()),)


def test_census_report_matches_jax(capsys):
    from bdm_db1_tpu.eval import geometry_census as jgc
    from bdm_db1_tpu_torch.eval import geometry_census as tgc

    jgc.main()
    want = capsys.readouterr().out
    tgc.main()
    assert capsys.readouterr().out == want
