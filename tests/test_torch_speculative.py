"""Speculative (Jacobi) decode in the port against the JAX package's
(db1_tiny, f32, CPU, same weights), the counterpart of
tests/test_speculative.py: the speculative chains equal the port's
sequential chains and the JAX package's speculative chains, with the same
verify rounds a call, with and without geometry buckets, through the
kernels' plain versions, across a split guess tail, on image primes (the
sliced prompt and the realigned one-shot prime), on an int8 cache and
with w8a8 weights; the lockstep cohort and the one-env episode equal the
classic decoder's; the spec-tail ring forward; the adaptive controller's
decisions and sessions, and a pool's registry of them
(``track_spec_sessions``); ``prewarm``.

Each JAX decoder is built once per module (its compiled programs are then
reused) and each of its chains runs once."""

import functools

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    episode_primes, fake_env_datasets, jax_tiny, one_thread, port_model,
)

OBS, ACT = 4, 3
# the ring forward's logits against JAX's (tests/test_parity.py's bar)
LOGIT_TOL = 2e-4


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _key(over):
    return tuple(sorted(over.items()))


@functools.lru_cache(maxsize=None)
def _jax_model(vision: bool, key):
    """(cfg, JAX model, params, numpy params) of db1_tiny with the model
    overrides ``key``; one per module, so its decoders' programs compile
    once."""
    return jax_tiny("off", vision=vision, **dict(key))


@functools.lru_cache(maxsize=None)
def _jax_decoder(geom, vision: bool, key, buckets=None):
    """A JAX decoder for the env geometry ``geom`` (obs_length,
    action_length, discrete, n) built on a tokenized env of that geometry."""
    from bdm_db1_tpu.eval.decode import build_decoder_for_env as jbuild

    _, jm, params, _ = _jax_model(vision, key)
    return jbuild(jm, params, _GEOM_ENVS[geom], pad_buckets=buckets)


_GEOM_ENVS = {}


def _decoders(jt, tt, buckets=None, vision=False, **over):
    """(JAX decoder, port decoder) of db1_tiny with ``over`` on the
    geometry of the tokenized envs jt / tt."""
    from bdm_db1_tpu.eval.harness import decode_geometry
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env

    geom = decode_geometry(jt[0])
    _GEOM_ENVS.setdefault(geom, jt[0])
    key = _key(over)
    jdec = _jax_decoder(geom, vision, key, buckets)
    pnp = _jax_model(vision, key)[3]
    tdec = build_decoder_for_env(port_model(pnp, "off", **over), tt[0],
                                 pad_buckets=buckets)
    return jdec, tdec


def _port_decoder(tt, flash="off", buckets=None, vision=False, **over):
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env

    pnp = _jax_model(vision, ())[3]
    return build_decoder_for_env(port_model(pnp, flash, **over), tt[0],
                                 pad_buckets=buckets)


def _chain(decoder, primes, defer=True):
    """(action blocks, verify rounds of each call) of consecutive decodes
    over one cache; a prime is tokens or (tokens, frames)."""
    first = primes[0][0] if isinstance(primes[0], tuple) else primes[0]
    mems = decoder.init_mems(first.shape[0])
    acts, rounds, deferred = [], [], None
    for p in primes:
        tok, img = p if isinstance(p, tuple) else (p, None)
        a, mems = decoder.decode(tok, mems, prime_images=img,
                                 deferred_tok=deferred, defer_last=defer)
        if defer:
            deferred = np.asarray(a)[..., -decoder.defer_width:]
        acts.append(np.asarray(a))
        r = getattr(decoder, "last_spec_rounds", None)
        rounds.append(None if r is None else int(r))
    return acts, rounds


def _same(got, want, what=""):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what} step {k}")


def _fresh_envs(n=2, obs=OBS, act=ACT, ep=6):
    return fake_env_datasets(n, obs, act, ep)


def _check_spec_chain(buckets=None, flash="off", seed=0, steps=4, obs=OBS,
                      act=ACT, defers=(True, False), **over):
    """The port's speculative chains (each ``defers``) equal its
    sequential chain and the JAX package's speculative chains, round for
    round."""
    jt, tt = _fresh_envs(obs=obs, act=act)
    primes = episode_primes(jt, seed, steps, obs)
    jdec, _ = _decoders(jt, tt, buckets, decode_speculative=True, **over)
    sdec = _port_decoder(tt, flash, buckets, decode_speculative=True, **over)
    assert sdec.speculates and sdec.defer_width == act
    ref, _ = _chain(_port_decoder(tt, flash, buckets, **{
        k: v for k, v in over.items() if k == "decode_weight_dtype"}),
        primes, defer=False)
    out = {}
    for defer in defers:
        want, want_r = _chain(jdec, primes, defer)
        got, got_r = _chain(sdec, primes, defer)
        _same(got, want, f"jax defer={defer}")
        assert got_r == want_r, (defer, got_r, want_r)
        assert all(0 <= r <= act - 1 for r in got_r), got_r
        out[defer] = (got, got_r, ref)
    return out


@pytest.mark.parametrize("buckets", [None, "default"])
def test_speculative_matches_sequential(buckets):
    """Deferred and folded speculative chains over an episode-start prime
    cut into ring slices and steady primes: equal to the sequential greedy
    actions and to JAX's speculative chains with the same rounds. With
    buckets (the deferred chain) the steady 8-token prime stays unpadded
    (its bucket, 8, is its width) and the prompt's last slice, 5 tokens,
    pads to 8 with the guesses between its real rows and its pads."""
    out = _check_spec_chain(buckets, defers=(True,) if buckets else
                            (True, False))
    for got, _, ref in out.values():
        _same(got, ref, "sequential")
    if buckets:
        tdec = _port_decoder(_fresh_envs()[1], buckets=buckets,
                             decode_speculative=True)
        widths, _, real = tdec.prime_plan(69, 0, speculate=True)
        assert (widths, real) == ([32, 32, 8], 5)
        assert tdec.spec_plan(widths, None, real) == ([32, 32, 8], None,
                                                      True)


def test_speculative_flash_kernels_match():
    """Through the ring kernels' route (their plain versions on the CPU,
    the card's route): the deferred chain equals the sequential one and
    JAX's speculative chain."""
    out = _check_spec_chain(flash="on", seed=3, steps=3, defers=(True,))
    got, _, ref = out[True]
    _same(got, ref, "sequential")


def test_speculative_tail_split():
    """A steady prime whose guess tail would pass mem_len (4 deferred + 25
    + 1 = 30 tokens, + 3 guesses = 33 > 32) cuts its last ring call in
    two; the actions equal the sequential ones and JAX's, round for
    round."""
    tdec = _port_decoder(_fresh_envs(obs=25, act=4)[1],
                         decode_speculative=True)
    assert tdec.model.cfg.mem_len == 32
    assert tdec.spec_plan([30], None, None) == ([1, 29], None, True)
    out = _check_spec_chain(seed=5, steps=3, obs=25, act=4, defers=(True,))
    got, _, ref = out[True]
    _same(got, ref, "sequential")


def _episodes(tenvs, dec):
    """(return, length) of each env's episode, the envs in one lockstep
    cohort, through the harness of the package the envs belong to."""
    from bdm_db1_tpu.eval import harness as jh
    from bdm_db1_tpu_torch.eval import harness as th

    port = type(tenvs[0]).__module__.startswith("bdm_db1_tpu_torch")
    res = (th if port else jh).run_batched_episodes(
        tenvs, dec, rng=np.random.RandomState(0))
    return [(r.episode_return, r.episode_length) for r in res]


def test_speculative_cohort_matches_nonspec():
    """``run_batched_episodes`` with a speculative decoder gives the
    classic decoder's records, and JAX's speculative records."""
    jt, tt = _fresh_envs(ep=5)
    _, tt2 = _fresh_envs(ep=5)
    jdec, sdec = _decoders(jt, tt, decode_speculative=True)
    assert _episodes(tt, sdec) == _episodes(jt, jdec) == _episodes(
        tt2, _port_decoder(tt2))


def _image_setup(hw, act=3):
    """Tokenized FakeContinuousImageEnv instances (hw x hw frames, ``act``
    action dims) in both packages over the same seeded trajectories."""
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
    out = []
    for envs, rd, scalar, tenv in ((je, jd, JScalar, JTenv),
                                   (te, td, TScalar, TTenv)):
        kw = dict(hw=hw, act_dim=act, episode_len=4)
        ds = rd.RLFullDataset(
            "img", rd.TrajectoryStore.from_flat_dataset(
                envs.FakeContinuousImageEnv(seed=999, **kw).make_dataset(5)),
            rd.RLTokenizerSuite(cfg.vocab.layout(),
                                scalar(cfg.vocab.num_continuous_bin)),
            seq_length=cfg.model.n_position, seed=0)
        out.append([tenv(envs.FakeContinuousImageEnv(seed=i, **kw), ds)
                    for i in range(2)])
    return out


@pytest.mark.parametrize("hw", [32, 96])
def test_speculative_image_geometry_matches(hw):
    """Continuous actions on image observations. At hw 32 (4 patches a
    frame) the episode-start prime is cut at transition boundaries with
    its frames and the guesses ride the last slice beside its frames; at
    hw 96 (36 patches) no prime fits one ring call: each is realigned,
    commits without guesses and the first verify round finds the
    candidates. The cohort's records equal the classic decoder's and
    JAX's speculative ones; the chain's rounds equal JAX's."""
    jt, tt = _image_setup(hw)
    jdec, sdec = _decoders(jt, tt, vision=True, decode_speculative=True)
    assert sdec.speculates
    want = _episodes(jt, jdec)
    got = _episodes(tt, sdec)
    jt2, tt2 = _image_setup(hw)
    ref = _episodes(tt2, _port_decoder(tt2, vision=True))
    assert got == want == ref
    # a chain of explicit primes: the rounds of each call are JAX's
    sep = np.full((2, 1), tt2[0].separator_id, np.int64)
    rng = np.random.RandomState(1)
    primes = []
    for k in range(3):
        rows = [(t.get_prompt(rng=rng) if k == 0 else (None, None)) + t.reset()
                for t in jt2]
        tok = np.stack([np.concatenate(([] if r[0] is None else [r[0]])
                                       + [r[2], sep[0]]) for r in rows])
        img = np.stack([np.concatenate(([] if r[1] is None else [r[1]])
                                       + [r[3]]) for r in rows])
        primes.append((tok, img))
    want, want_r = _chain(jdec, primes)
    got, got_r = _chain(sdec, primes)
    _same(got, want, "jax")
    assert got_r == want_r
    if hw == 96:
        assert min(got_r) >= 1     # no tail: at least one verify round


def test_speculative_disabled_for_discrete():
    """One action token has nothing to guess: classic defer_last under
    either flag, as in the JAX package."""
    from bdm_db1_tpu.eval.decode import ActionDecoder as JDecoder
    from bdm_db1_tpu_torch.eval.decode import ActionDecoder

    for over in (dict(decode_speculative=True),
                 dict(decode_spec_adaptive=True)):
        cfg, jm, params, pnp = _jax_model(False, _key(over))
        tm = port_model(pnp, **over)
        layout = cfg.vocab.layout()
        for discrete, n in ((True, 5), (False, None)):
            jdec = JDecoder(jm, params, layout, 4, 1, discrete, n)
            tdec = ActionDecoder(tm, layout, 4, 1, discrete, n)
            assert (tdec.speculates, tdec.spec_adaptive, tdec.defer_width) \
                == (jdec.speculates, jdec.spec_adaptive, jdec.defer_width) \
                == (False, False, 1)
        # more than one continuous token: speculation on
        jdec = JDecoder(jm, params, layout, 4, 3, False)
        tdec = ActionDecoder(tm, layout, 4, 3, False)
        assert (tdec.speculates, tdec.spec_adaptive, tdec.defer_width) == (
            jdec.speculates, jdec.spec_adaptive, jdec.defer_width)


@pytest.mark.parametrize("over", [
    dict(decode_cache_dtype="int8"),
    dict(decode_weight_dtype="int8a8"),
    dict(decode_weight_dtype="int8a8", decode_cache_dtype="int8")],
    ids=["int8_cache", "w8a8", "w8a8_int8_cache"])
def test_speculative_quantized_matches_jax(over):
    """Speculative chains on an int8 ring cache (the real rows committed
    quantized, the guesses attending this call's unquantized rows), with
    w8a8 trunk weights (row-independent activation scales: the chains also
    equal the sequential w8a8 chain) and both together: equal to JAX's
    speculative chains round for round, the tokens in the continuous
    range."""
    from bdm_db1_tpu_torch.core.config import db1_tiny

    out = _check_spec_chain(seed=7 + len(over), steps=3, defers=(True,),
                            **over)
    got, _, ref = out[True]
    layout = db1_tiny().vocab.layout()
    for a in got:
        assert ((a >= layout.continuous_offset)
                & (a < layout.separator_id)).all(), a
    if over == dict(decode_weight_dtype="int8a8"):
        _same(got, ref, "sequential w8a8")


def test_speculative_verify_that_never_settles_raises():
    """A verify forward whose candidates change every round (as a route
    that is not deterministic would make them) stops the loop after
    S + 1 rounds with an error, where it would otherwise never end."""
    from bdm_db1_tpu_torch.core.config import db1_tiny

    jt, tt = _fresh_envs()
    sdec = _port_decoder(tt, decode_speculative=True)
    S = sdec.action_length - 1
    layout = db1_tiny().vocab.layout()
    model, real = sdec.model, sdec.model.decode_rl_kv_ring
    verifies = []

    def flipping(tok, pos, mems, rk, *a, spec_tail=0, **kw):
        logits, mems = real(tok, pos, mems, rk, *a, spec_tail=spec_tail,
                            **kw)
        if spec_tail == S and tok.shape[1] == S:
            logits = logits.clone()
            logits[..., layout.continuous_offset + len(verifies) % 2] += 1e6
            verifies.append(1)
        return logits, mems

    model.decode_rl_kv_ring = flipping
    prime = episode_primes(jt, 0, 1, OBS)[0]
    with pytest.raises(RuntimeError, match="did not settle"):
        sdec.decode(prime, sdec.init_mems(prime.shape[0]), defer_last=True)
    assert len(verifies) == S + 1


def test_spec_tail_pure_verify_leaves_cache_untouched():
    """``decode_rl_kv_ring`` with the whole call a tail commits nothing:
    the cache tensors and the cursor come back as they were, and the
    logits of every row are JAX's."""
    import jax.numpy as jnp

    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL

    _, jm, params, pnp = _jax_model(False, ())
    tm = port_model(pnp)
    jt, tt = _fresh_envs()
    tdec = _port_decoder(tt)
    mems = tdec.init_mems(1)
    # a committed prime first, so the cache is not all zeros
    prime = episode_primes(tt, 2, 1, OBS)[0][:1]
    _, mems = tdec.decode(prime, mems, defer_last=True)
    before = {k: v.clone() for k, v in mems.items() if torch.is_tensor(v)}
    toks = torch.tensor([[5, 6, 7]])
    pos = torch.zeros((1, 3), dtype=torch.int64)
    logits, cache = tm.decode_rl_kv_ring(toks, pos, mems,
                                         tm.precompute_rk(3), spec_tail=3)
    assert logits.shape[:2] == (1, 3) and logits.ndim == 3
    assert cache["cursor"] == mems["cursor"]
    for k, v in before.items():
        assert torch.equal(cache[k], v), k
    jmems = {k: jnp.asarray(v.numpy()) for k, v in before.items()}
    jmems["cursor"] = jnp.int32(mems["cursor"])
    lj, cj = jm.apply({"params": params}, jnp.asarray(toks.numpy()),
                      jnp.asarray(pos.numpy()), jmems,
                      jm.apply({"params": params}, 3,
                               method=JaxTXL.precompute_rk),
                      method=JaxTXL.decode_rl_kv_ring, spec_tail=3)
    lj = np.asarray(lj)
    assert np.abs(logits.numpy() - lj).max() <= LOGIT_TOL * np.abs(lj).max()
    assert int(cj["cursor"]) == cache["cursor"]


# ---- adaptive speculation -------------------------------------------------

ROUNDS = [0, 0, 5, 3, 0.5, 4, 4, 4, 1, 0, 2, 2, 2, 2, 2, 0, 5, 5, 5, 5, 0]


@pytest.mark.parametrize("kw", [
    dict(exit_rounds=2.0, reenter_rounds=1.0, probe_every=3, alpha=1.0,
         min_obs=2),
    dict(exit_rounds=1.0, reenter_rounds=0.5, alpha=1.0, min_obs=3),
    dict(exit_rounds=1.2, reenter_rounds=1.0, probe_every=2, alpha=0.25,
         min_obs=4),
    dict()])
def test_spec_controller_matches_jax(kw):
    """On one fixed sequence of rounds (a speculative step observes the
    next one) the port's controller takes JAX's decisions and ends in
    JAX's state; the first case walks the JAX test's exit, probe and
    re-entry."""
    from bdm_db1_tpu.eval.decode import SpecController as JCtl
    from bdm_db1_tpu_torch.eval.decode import SpecController

    jc, tc = JCtl(**kw), SpecController(**kw)
    feed = iter(ROUNDS * 3)
    trace = []
    for _ in range(60):
        dj, dt = jc.decide(), tc.decide()
        assert dj is dt
        trace.append(dt)
        if dt:
            r = next(feed)
            jc.observe(r)
            tc.observe(r)
    assert vars(jc) == vars(tc)
    if kw.get("probe_every") == 3:
        assert tc.switches >= 2 and not all(trace)


def _chain_adaptive(sess, primes):
    mems = sess.decoder.init_mems(primes[0].shape[0])
    acts, deferred = [], None
    for p in primes:
        a, mems = sess.decode(p, mems, deferred_tok=deferred,
                              defer_last=True)
        deferred = np.asarray(a)[..., -sess.defer_width:]
        acts.append(np.asarray(a))
    return acts


def test_adaptive_session_matches_sequential_across_switches():
    """A controller forced to flip every couple of steps runs
    spec -> classic, classic -> spec and spec -> spec carries; the
    actions equal the sequential decoder's and the JAX session's, and the
    controllers end in the same state."""
    from bdm_db1_tpu.eval.decode import AdaptiveSpecSession as JSess
    from bdm_db1_tpu.eval.decode import SpecController as JCtl
    from bdm_db1_tpu_torch.eval.decode import (
        AdaptiveSpecSession, SpecController,
    )

    jt, tt = _fresh_envs(ep=8)
    jdec, adec = _decoders(jt, tt, decode_speculative=True)
    S = adec.action_length - 1
    kw = dict(exit_rounds=-1.0, reenter_rounds=S, probe_every=2, alpha=1.0,
              min_obs=1)
    ctl, jctl = SpecController(**kw), JCtl(**kw)
    primes = episode_primes(jt, 7, 6, OBS)
    ref, _ = _chain(_port_decoder(tt), primes, defer=False)
    got = _chain_adaptive(AdaptiveSpecSession(adec, ctl), primes)
    want = _chain_adaptive(JSess(jdec, jctl), primes)
    _same(got, ref, "sequential")
    _same(got, want, "jax")
    assert ctl.switches >= 2 and 0 < ctl.spec_steps < ctl.total_steps
    assert ctl.rounds_n == ctl.spec_steps
    assert vars(ctl) == vars(jctl)


def test_adaptive_decoder_flag_and_defaults():
    """``decode_spec_adaptive`` alone turns speculation on, and the
    default controller scales with the action length as JAX's does."""
    from bdm_db1_tpu.eval.decode import AdaptiveSpecSession as JSess
    from bdm_db1_tpu_torch.eval.decode import AdaptiveSpecSession

    jt, tt = _fresh_envs(1, act=4, ep=4)
    jdec, adec = _decoders(jt, tt, decode_spec_adaptive=True)
    assert adec.speculates and adec.spec_adaptive
    assert (jdec.speculates, jdec.spec_adaptive) == (True, True)
    sess, jsess = AdaptiveSpecSession(adec), JSess(jdec)
    S = adec.action_length - 1
    assert sess.ctl.exit_rounds == 0.6 * S == jsess.ctl.exit_rounds
    assert sess.ctl.reenter_rounds == 0.5 * S == jsess.ctl.reenter_rounds
    assert vars(sess.ctl) == vars(jsess.ctl)


def test_adaptive_cohort_and_episode_match_nonspec():
    """``run_batched_episodes`` and the one-env ``run_episode`` with an
    adaptive decoder (the default controller, prewarmed once) give the
    classic decoder's records and the JAX package's adaptive ones."""
    from bdm_db1_tpu.eval import harness as jh
    from bdm_db1_tpu_torch.eval import harness as th

    jt, tt = _fresh_envs(ep=5)
    jdec, adec = _decoders(jt, tt, decode_spec_adaptive=True)
    assert adec.spec_adaptive
    got = _episodes(tt, adec)
    got1 = th.run_episode(tt[0], adec, use_prompt=True,
                          rng=np.random.RandomState(3))
    want = _episodes(jt, jdec)
    want1 = jh.run_episode(jt[0], jdec, use_prompt=True,
                           rng=np.random.RandomState(3))
    _, tt2 = _fresh_envs(ep=5)
    dec = _port_decoder(tt2)
    ref = _episodes(tt2, dec)
    ref1 = th.run_episode(tt2[0], dec, use_prompt=True,
                          rng=np.random.RandomState(3))
    assert got == want == ref
    assert ((got1.episode_return, got1.episode_length)
            == (want1.episode_return, want1.episode_length)
            == (ref1.episode_return, ref1.episode_length))
    assert adec.spec_prewarmed


def test_pool_tracks_spec_sessions_in_creation_order(monkeypatch):
    """``DecoderPool(track_spec_sessions=True)``: every
    ``AdaptiveSpecSession`` made on its decoders (the cohort's, the
    one-env episode's, one by hand) is in ``spec_sessions``, in creation
    order; off, the pool keeps none (``spec_sessions`` None), as JAX's
    pool does."""
    from bdm_db1_tpu.eval.decode import DecoderPool as JPool
    from bdm_db1_tpu_torch.eval import harness as th
    from bdm_db1_tpu_torch.eval.decode import (
        AdaptiveSpecSession, DecoderPool,
    )

    made = []

    class Recorded(AdaptiveSpecSession):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(th, "AdaptiveSpecSession", Recorded)
    over = {"decode_spec_adaptive": True}
    jt, tt = _fresh_envs(ep=3)
    _, jm, params, pnp = _jax_model(False, _key(over))
    model = port_model(pnp, "off", **over)
    for track in (True, False):
        made.clear()
        pool = DecoderPool(model, track_spec_sessions=track)
        dec = pool.get(tt[0])
        assert dec.spec_adaptive and pool.get(tt[1]) is dec
        _episodes(tt, dec)
        th.run_episode(tt[0], dec, use_prompt=True,
                       rng=np.random.RandomState(3))
        made.append(AdaptiveSpecSession(dec))
        assert len(made) == 3
        jpool = JPool(jm, params, track_spec_sessions=track)
        if track:
            assert len(pool.spec_sessions) == 3 and jpool.spec_sessions == []
            assert all(a is b for a, b in zip(pool.spec_sessions, made))
        else:
            assert pool.spec_sessions is jpool.spec_sessions is None
            assert getattr(dec, "spec_sessions", None) is None


def test_adaptive_prewarm_covers_all_switch_widths():
    """``prewarm`` runs both modes at both deferred widths at the steady
    geometry: afterwards every dispatch a switch can make finds its
    positional projections in the ``RkCache`` (the widths JAX's prewarm
    leaves in its rk cache), and the controller and guesses are
    untouched."""
    from bdm_db1_tpu_torch.eval.decode import AdaptiveSpecSession, RkCache

    jt, tt = _fresh_envs(ep=6)
    _, adec = _decoders(jt, tt, decode_spec_adaptive=True)
    adec._rk = RkCache(adec.model)
    sess = AdaptiveSpecSession(adec)
    steady = episode_primes(tt, 11, 2, OBS)[1]          # [B, obs + sep]
    sess.prewarm(steady)
    assert sess.ctl.total_steps == 0 and sess._guess is None
    widths = set(adec._rk.widths())
    A, S = adec.action_length, adec.action_length - 1
    q = steady.shape[1]
    # spec: lead w, + S guesses; verify S; classic: lead w, then q == 1
    assert widths == {1, S, q + 1 + S, q + A + S, q + 1, q + A}, widths
    calls = []
    real_get = adec._rk.get

    def get(w):
        calls.append(w)
        return real_get(w)

    adec._rk.get = get
    guess = np.full((2, A), adec._default_guess, np.int64)
    for spec in (True, False):
        for w in (1, A):
            act, _ = adec.decode_async(steady, adec.init_mems(2),
                                       deferred_tok=guess[:, :w],
                                       defer_last=True, speculate=spec,
                                       guess_tok=guess)
            act.cpu()
    assert set(calls) <= widths and set(adec._rk.widths()) == widths
