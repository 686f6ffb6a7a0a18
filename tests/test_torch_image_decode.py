"""Image primes in the port's RL decode against the JAX package's
ActionDecoder (db1_tiny, f32, CPU, same weights): greedy action chains on
FakeImageEnv (one discrete action token) and FakeContinuousImageEnv (two
continuous tokens) with an expert prompt that ``_image_chunk_plan`` cuts
into ring slices, then one-slice [deferred || obs || sep] primes; a
prompt prime longer than mem_len that the plan cannot cut (the aligned
realign); the same chains on an int8 cache, with and without geometry
buckets; and ``_image_chunk_plan`` over a grid of (q, n_frames)."""

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    image_env_datasets, image_primes, jax_tiny, one_thread, port_model,
)

N_ENVS = 2


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _chain(decoder, primes):
    mems = decoder.init_mems(N_ENVS)
    acts, deferred = [], None
    for tok, img in primes:
        a, mems = decoder.decode(tok, mems, prime_images=img,
                                 deferred_tok=deferred, defer_last=True)
        deferred = np.asarray(a)[:, -1]
        acts.append(np.asarray(a))
    return acts


@pytest.mark.parametrize("kind,hw,flash", [
    ("discrete", 32, "on"), ("continuous", 32, "off"),
    ("continuous", 96, "on")])
def test_image_chains_match_jax(kind, hw, flash):
    """Four env steps at batch 2. At hw 32 the episode-start prime (11
    prompt transitions + obs + sep, 71 tokens with a discrete action) is
    cut by ``_image_chunk_plan`` into transition-aligned slices with their
    frames; at hw 96 (36 patches, a transition longer than the 32-token
    slice budget) the plan refuses and the prime, longer than mem_len,
    runs once over the realigned cache. Later primes are one slice."""
    _check_image_chains(kind, hw, flash)


@pytest.mark.parametrize("kind,hw,flash,buckets", [
    ("discrete", 32, "on", None), ("continuous", 32, "off", None),
    ("discrete", 96, "off", None), ("continuous", 96, "on", None),
    ("discrete", 32, "off", "default"), ("continuous", 32, "on", "default")])
def test_image_chains_on_an_int8_cache_match_jax(kind, hw, flash, buckets):
    """The same chains with ``decode_cache_dtype="int8"`` in both packages:
    the sliced prime writes quantized rows; the realigned prime (hw 96)
    dequantizes the ring, primes the aligned cache and quantizes it again.
    With buckets the steady [deferred || obs || sep] primes (6 tokens at
    hw 32) and the last prompt slice are padded to their bucket widths."""
    _check_image_chains(kind, hw, flash, buckets,
                        decode_cache_dtype="int8")


def _check_image_chains(kind, hw, flash, buckets=None, **over):
    from bdm_db1_tpu.eval.decode import build_decoder_for_env as jbuild
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env as tbuild

    _, model, params, pnp = jax_tiny("off", vision=True, **over)
    jt, tt = image_env_datasets(kind, hw)
    primes = image_primes(jt, 4)
    tprimes = image_primes(tt, 4)
    for (a, fa), (b, fb) in zip(primes, tprimes):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(fb, fa)
    jdec = jbuild(model, params, jt[0], pad_buckets=buckets)
    tdec = tbuild(port_model(pnp, flash, **over), tt[0], pad_buckets=buckets)
    q0, n0 = primes[0][0].shape[1], primes[0][1].shape[1]
    sizes, frames = tdec.chunk_plan(q0, 0, n0)
    if hw == 32:
        assert sizes is not None and len(sizes) > 1 and sum(frames) == n0
    else:
        assert sizes is None and q0 > tdec.model.cfg.mem_len
    if buckets:
        q1 = primes[1][0].shape[1] + 1
        assert tdec.prime_plan(q1, 1, 1)[::2] == ([8], q1)
    want = _chain(jdec, primes)
    got = _chain(tdec, primes)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {i}")


def test_image_chunk_plan_matches_jax():
    """Both geometries' plans over q in [1, 200) and 0-39 frames."""
    from bdm_db1_tpu.eval.decode import build_decoder_for_env as jbuild
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env as tbuild

    _, model, params, pnp = jax_tiny("off", vision=True)
    pm = port_model(pnp)
    for kind in ("discrete", "continuous"):
        jt, tt = image_env_datasets(kind, 32)
        jdec, tdec = jbuild(model, params, jt[0]), tbuild(pm, tt[0])
        cut = 0
        for q in range(1, 200):
            for nf in range(40):
                want = jdec._image_chunk_plan(q, nf)
                got = tdec._image_chunk_plan(q, nf)
                assert got == want, (kind, q, nf)
                cut += want is not None
        assert cut > 20


# decode_rl_kv against the JAX package's (f32): relative to the largest
# JAX logit, and absolute on the new cache rows
ALIGNED_LOGIT_TOL = 2e-4
ALIGNED_CACHE_TOL = 2e-4


@pytest.mark.parametrize("impl,same_length,kernel_route", [
    ("pallas", True, True), ("pallas", False, True), ("auto", True, False)])
def test_aligned_prime_takes_the_trunk_route(impl, same_length,
                                             kernel_route):
    """``decode_rl_kv`` (the realigned one-shot prime) over a seeded
    aligned cache at mem_len 512 and q 64, a shape the JAX padding wrapper
    takes: logits and the new cache against JAX's ``decode_rl_kv``
    ("xla"). Under "pallas" every layer goes through K3's route (its plain
    version on the CPU), as the card's "auto" does; "auto" on the CPU takes
    ``rel_attention``."""
    import jax
    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
    from bdm_db1_tpu_torch.ops import flash_rel_attention as tk

    over = dict(mem_len=512, same_length=same_length)
    cfg, jm, params, pnp = jax_tiny(attention_impl="xla", **over)
    tm = port_model(pnp, attention_impl=impl, **over)
    c = cfg.model
    B, q, M = 2, 64, c.mem_len
    assert tk.kernel_route_applicable(q, M + q)
    rng = np.random.RandomState(5)
    tok = rng.randint(0, cfg.vocab.layout().total_vocab_size,
                      (B, q)).astype(np.int64)
    pos = np.broadcast_to(np.arange(q) % c.n_position, (B, q)).copy()
    kv = [rng.randn(c.n_layer, B, M, c.n_head, c.d_head).astype(np.float32)
          for _ in "kv"]
    logits_j, new_j = jax.jit(lambda p, t, s, k, v: jm.apply(
        {"params": p}, t, s, {"k": k, "v": v}, None,
        jm.apply({"params": p}, q, method=JaxTXL.precompute_rk),
        method=JaxTXL.decode_rl_kv))(params, tok, pos, *kv)
    calls = []
    real = tk.flash_rel_attention_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    tk.flash_rel_attention_plain = spy
    try:
        logits_t, new_t = tm.decode_rl_kv(
            torch.from_numpy(tok), torch.from_numpy(pos),
            {"k": torch.from_numpy(kv[0]), "v": torch.from_numpy(kv[1]),
             "cursor": 0}, tm.precompute_rk(q))
    finally:
        tk.flash_rel_attention_plain = real
    assert len(calls) == (c.n_layer if kernel_route else 0)
    lj = np.asarray(logits_j)
    err = np.abs(logits_t.numpy() - lj).max() / np.abs(lj).max()
    assert err <= ALIGNED_LOGIT_TOL, err
    assert new_t["cursor"] == 0
    for key in "kv":
        np.testing.assert_allclose(new_t[key].numpy(), np.asarray(new_j[key]),
                                   rtol=0, atol=ALIGNED_CACHE_TOL)
