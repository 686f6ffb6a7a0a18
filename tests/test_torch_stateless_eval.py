"""The stateless (no-memory) evaluation in the port against the JAX
package's, on the CPU at db1_tiny in f32 (the counterpart of
tests/test_stateless_eval.py): ``WindowDecoder`` actions for one row, for
a batch of rows of different lengths and with an action mask; the
stateless episode under both prompt strategies; the window decode against
the ring decode of the same sequence; the window through K3's route;
``parallel_evaluate_envs`` at world size 1, and its refusal above."""

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tiny, one_thread, port_model

OBS, ACT, EP_LEN = 4, 2, 12
# first-action logits of two routes or two decoders (tests/test_parity.py's
# bar): max |diff| at most LOGIT_TOL * max |logit|
LOGIT_TOL = 2e-4
STATELESS = dict(mem_len=0, same_length=False)


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _tenvs(n_position=64, strategy="fixed_prompt", seed=0):
    """A FakeContinuousEnv(4, 2) tokenized in both packages over the same
    seeded dataset (prompt ratio 0.3): (JAX, port)."""
    from bdm_db1_tpu.core.config import db1_tiny
    from bdm_db1_tpu.data import rl_dataset as jd
    from bdm_db1_tpu.eval import envs as je
    from bdm_db1_tpu.eval.wrapper import TokenizedEnv as JTenv
    from bdm_db1_tpu.tokenizers.scalar import ScalarTokenizer as JScalar
    from bdm_db1_tpu.tokenizers.text import ByteTextTokenizer
    from bdm_db1_tpu_torch.data import rl_dataset as td
    from bdm_db1_tpu_torch.eval import envs as te
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv as TTenv
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer as TScalar

    cfg = db1_tiny()
    kw = dict(obs_dim=OBS, act_dim=ACT, episode_len=EP_LEN)
    out = []
    for rd, envs, scalar, tenv in ((jd, je, JScalar, JTenv),
                                   (td, te, TScalar, TTenv)):
        suite = rd.RLTokenizerSuite(
            cfg.vocab.layout(), scalar(cfg.vocab.num_continuous_bin),
            ByteTextTokenizer(), vision_patch_size=cfg.vision.patch_size)
        ds = rd.RLFullDataset(
            "fake", rd.TrajectoryStore.from_flat_dataset(
                envs.FakeContinuousEnv(seed=9, **kw).make_dataset(5)),
            suite, seq_length=n_position, use_prompt=True, prompt_ratio=0.3,
            seed=0)
        out.append(tenv(envs.FakeContinuousEnv(seed=seed, **kw), ds,
                        eval_prompt_strategy=strategy))
    return out


def _decoders(jt, tt, n_position=64, impl=None, **over):
    """(JAX WindowDecoder, port WindowDecoder) of db1_tiny with ``over``;
    ``impl`` the port's attention_impl (the JAX side takes "xla")."""
    from bdm_db1_tpu.eval.decode import WindowDecoder as JWindow
    from bdm_db1_tpu_torch.eval.decode import WindowDecoder

    over = dict(n_position=n_position, **over)
    cfg, jm, params, pnp = jax_tiny(attention_impl="xla", **over)
    tm = port_model(pnp, attention_impl=impl or "xla", **over)
    layout = cfg.vocab.layout()
    geom = (jt.obs_length, jt.action_length, False)
    return (JWindow(jm, params, layout, *geom),
            WindowDecoder(tm, layout, *geom))


def _seqs(tenv, decoder, n=2):
    """Sequences of growing history: [obs || sep], then one more whole
    transition each (its action from the decoder)."""
    sep = [tenv.separator_id]
    obs, _, _ = tenv.reset()
    seqs = [np.concatenate([obs, sep])]
    for _ in range(n - 1):
        act, ext = decoder.decode(seqs[-1])
        obs, _, _ = tenv.reset()
        seqs.append(np.concatenate([ext, obs, sep]))
    return seqs


def test_window_decoder_matches_jax():
    """One row: the action tokens in the continuous range, the sequence
    extended by them, and JAX's tokens."""
    jt, tt = _tenvs()
    jdec, tdec = _decoders(jt, tt, **STATELESS)
    layout = tt.tok.layout
    for seq in _seqs(tt, tdec, 3):
        act, ext = tdec.decode(seq)
        want, jext = jdec.decode(seq)
        assert act.shape == (ACT,)
        assert ((act >= layout.continuous_offset)
                & (act < layout.separator_id)).all()
        np.testing.assert_array_equal(ext[:-ACT], seq)
        np.testing.assert_array_equal(ext[-ACT:], act)
        np.testing.assert_array_equal(act, want)
        np.testing.assert_array_equal(ext, jext)


def test_window_decoder_batch_matches_single_and_jax():
    """Rows of different live lengths in one batch: each equals its own
    single-row decode and JAX's batch; a discrete geometry with an action
    mask ([n] and [B, n]) equals JAX's too."""
    from bdm_db1_tpu.eval.decode import WindowDecoder as JWindow
    from bdm_db1_tpu_torch.eval.decode import WindowDecoder

    jt, tt = _tenvs()
    jdec, tdec = _decoders(jt, tt, **STATELESS)
    seqs = _seqs(tt, tdec, 3)
    acts, ext = tdec.decode_batch(seqs)
    want, jext = jdec.decode_batch(seqs)
    np.testing.assert_array_equal(acts, want)
    for i, s in enumerate(seqs):
        np.testing.assert_array_equal(acts[i], tdec.decode(s)[0])
        np.testing.assert_array_equal(ext[i], jext[i])
        np.testing.assert_array_equal(ext[i][:len(s)], s)
    # a discrete action of 5 values, some banned
    n = 5
    jd = JWindow(jdec.model, jdec.params, jdec.layout, OBS, 1, True, n)
    td = WindowDecoder(tdec.model, tdec.layout, OBS, 1, True, n)
    rows = [s[:OBS + 1] for s in seqs]
    for mask in (np.array([0, 1, 1, 0, 1]),
                 np.array([[1, 0, 0, 0, 0], [0, 0, 1, 1, 0],
                           [0, 0, 0, 0, 1]])):
        got, _ = td.decode_batch(rows, env_action_mask=mask)
        ref, _ = jd.decode_batch(rows, env_action_mask=mask)
        np.testing.assert_array_equal(got, ref)
        m = np.broadcast_to(mask, (3, n))
        picked = got[:, 0] - tdec.layout.discrete_offset
        assert m[np.arange(3), picked].all()


@pytest.mark.parametrize("strategy", ["fixed_prompt", "moving_prompt"])
def test_stateless_episode_matches_jax(strategy):
    """A whole episode without memory: the host rolls the sequence to the
    window (the fixed prompt pinned, or the oldest transition dropped);
    the return and length equal JAX's."""
    from bdm_db1_tpu.eval.harness import run_episode_stateless as jrun
    from bdm_db1_tpu_torch.eval.harness import run_episode_stateless

    jt, tt = _tenvs(strategy=strategy)
    jdec, tdec = _decoders(jt, tt, **STATELESS)
    kw = dict(use_prompt=True, prompt_strategy=strategy)
    got = run_episode_stateless(tt, tdec, rng=np.random.RandomState(0), **kw)
    want = jrun(jt, jdec, rng=np.random.RandomState(0), **kw)
    assert got.episode_length == EP_LEN
    assert np.isfinite(got.episode_return)
    assert (got.env_name, got.episode_return, got.episode_length) == (
        want.env_name, want.episode_return, want.episode_length)
    # and without a prompt
    jt, tt = _tenvs(strategy=strategy, seed=1)
    got = run_episode_stateless(tt, tdec, use_prompt=False, max_step_size=5)
    want = jrun(jt, jdec, use_prompt=False, max_step_size=5)
    assert (got.episode_return, got.episode_length) == (
        want.episode_return, want.episode_length) and got.episode_length == 5


@pytest.mark.parametrize("n_position", [128, 64])
def test_window_decode_equals_ring_decode(n_position):
    """db1_tiny with same_length (mem_len 32). The ring decode of a stream
    attends its 32 zero memory rows beside the stream's keys; the window
    forward given that zero memory ([n_layer, 1, 32, D] zeros through
    ``trunk``) attends the same keys: equal first-action logits. Without
    memory the window equals the ring too once the sequence is longer
    than the 2 layers x 32 keys that reach its last row (the 128-token
    window), and then so do the action tokens."""
    from bdm_db1_tpu_torch.data.packing import action_flags_and_position_ids
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env

    W = n_position
    jt, tt = _tenvs(n_position=W)
    _, tdec = _decoders(jt, tt, n_position=W)
    model = tdec.model
    assert model.cfg.same_length and model.cfg.mem_len == 32
    seq = _seqs(tt, tdec, W // 8)[-1]
    while len(seq) + ACT > W:
        seq = seq[OBS + ACT + 1:]
    assert W // 2 < len(seq) <= W - ACT
    q = len(seq)
    _, pos = action_flags_and_position_ids(W, OBS, ACT, 0)
    window = torch.zeros((1, W), dtype=torch.int64)
    window[0, :q] = torch.as_tensor(seq)
    ring = build_decoder_for_env(model, tt)
    with torch.no_grad():
        emb = model.embed_rl(window, torch.as_tensor(pos)[None])
        lw = model.logits(model.trunk(emb, None)[0][:, q - 1])
        lz = model.logits(model.trunk(emb, model.init_mems(1))[0][:, q - 1])
        mems = ring.init_mems(1)
        widths, _, _ = ring.prime_plan(q, 0)
        start = 0
        for w in widths:
            lr, mems = model.decode_rl_kv_ring(
                torch.as_tensor(seq[None, start:start + w]),
                torch.as_tensor(pos[None, start:start + w]), mems,
                model.precompute_rk(w))
            start += w
    assert len(widths) > 1
    tol = LOGIT_TOL * float(lr.abs().max())
    assert float((lz - lr).abs().max()) <= tol
    if q > 2 * 32:
        assert float((lw - lr).abs().max()) <= tol
        np.testing.assert_array_equal(tdec.decode(seq)[0],
                                      ring.decode(seq, ring.init_mems(1))[0])


def test_window_through_the_kernel_route():
    """A 1024-token window (db1_1p2b's n_position) under
    attention_impl "pallas": every forward takes K3's route (its plain
    version here, the kernel on the card) and gives the actions of the
    "xla" route and of JAX's window decoder."""
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel

    jt, tt = _tenvs(n_position=1024)
    jdec, kdec = _decoders(jt, tt, n_position=1024, impl="pallas",
                           mem_len=1024)
    _, xdec = _decoders(jt, tt, n_position=1024, mem_len=1024)
    assert use_rel_kernel(kdec.model.cfg, 1024, 1024, "cpu")
    assert not use_rel_kernel(xdec.model.cfg, 1024, 1024, "cpu")
    seqs = _seqs(tt, xdec, 2)
    got, _ = kdec.decode_batch(seqs)
    np.testing.assert_array_equal(got, xdec.decode_batch(seqs)[0])
    np.testing.assert_array_equal(got, jdec.decode_batch(seqs)[0])


def test_parallel_evaluate_envs_matches_jax(monkeypatch):
    """One process: each env's record through ``evaluate_env`` with a
    shared pool equals JAX's. As rank 1 of a world of two (a stand-in
    ``torch.distributed``): only its shard is evaluated, and the gather
    returns rank 0's records, then its own."""
    from bdm_db1_tpu.eval.harness import parallel_evaluate_envs as jpar
    from bdm_db1_tpu_torch.eval import harness as th

    _, jm, params, pnp = jax_tiny()

    def make(pkg):
        def fn(name):
            jt, tt = _tenvs(seed=int(name[-1]))
            return jt if pkg == "jax" else tt
        return fn

    names = ["fake-0", "fake-1"]
    kw = dict(num_trials=2, seed=3, max_step_size=4)
    want = jpar(jm, params, names, make("jax"), **kw)
    got = th.parallel_evaluate_envs(port_model(pnp), names, make("port"),
                                    **kw)
    assert got == want and len(got) == 2
    shards = []

    def all_gather_object(out, local):
        shards.append(local)
        out[:] = [want[:1], local]

    monkeypatch.setattr(th.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(th.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(th.dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(th.dist, "all_gather_object", all_gather_object)
    got = th.parallel_evaluate_envs(port_model(pnp), names, make("port"),
                                    **kw)
    assert shards == [want[1:]] and got == want
