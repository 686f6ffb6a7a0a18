"""The port's int8 ring cache against the JAX package's on the CPU:

- ``quantize_kv_rows``: int8 values and scales equal exactly.
- the plain K6 (q == 1), K7 (2 <= Q <= 32, scales [L, B, M, H]) and K8
  (per-head prime, scales [L, B, H, M]) against the JAX int8 Pallas kernels
  in interpret mode, on int8 caches made by JAX's ``quantize_kv_rows``, with
  the block layout and banned slots of tests/test_torch_flash_ring_decode.py:
  1e-5 abs on o/l and m, 1e-5 rel on l (f32 throughout).
- ``decode_rl_kv_ring`` at db1_tiny in f32 with ``decode_cache_dtype="int8"``
  (and trunk weights "int8" / "int8a8") over the q sequence of
  tests/test_kv_cache.py (6, 1, 1, 9, 1, 30, 1, 4, 26, 1: crossing the
  wraparound), decode_flash "on" and "off": logits within 1e-4 of the
  largest logit, the int8 cache with at most a few entries one step apart
  (a rounding flip when a value sits on a .5 boundary), scales within
  1e-5 relative, and the cursor equal after every forward.
- greedy action chains through ``ActionDecoder`` equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
from bdm_db1_tpu.models.transformer_xl import (
    quantize_decode_weights, quantize_kv_rows as j_quantize_kv_rows,
)
from bdm_db1_tpu.ops import flash_ring_decode as jf
from bdm_db1_tpu_torch.models.transformer_xl import (
    dequantize_kv, quantize_kv_rows,
)
from bdm_db1_tpu_torch.ops import flash_ring_decode as tf
from torch_port_helpers import (
    episode_primes, fake_env_datasets, greedy_chain, jax_tiny, one_thread,
    port_model,
)

TOL = 1e-5
L, B, M, H, DH = 3, 2, 16, 4, 8
BLOCK = 8
SCALE = 1.0 / np.sqrt(DH)
# logits of the int8-cache decode, port against JAX: max |diff| at most
# LOGIT_TOL * max |logit|. Both compute in f32 on identical int8 caches;
# what is left is summation order (~1e-6) and, rarely, one cache entry
# rounded the other way, which moves a logit by one int8 step of one key.
LOGIT_TOL = 1e-4
MAX_FLIPS = 8          # cache entries one int8 step apart, over the run


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def test_quantize_kv_rows_matches_jax():
    x = np.random.RandomState(0).randn(3, 5, 4, 8).astype(np.float32)
    x[1, 2, 3] = 0.0                         # zero row: scale 1e-8 / 127
    q_j, s_j = j_quantize_kv_rows(jnp.asarray(x))
    q_t, s_t = quantize_kv_rows(torch.from_numpy(x))
    assert q_t.dtype == torch.int8 and s_t.shape == (3, 5, 4)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    back = dequantize_kv(q_t, s_t, torch.float32)
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        float(s_t.max()) / 2 + 1e-7


def _int8_inputs(seed, Q):
    rng = np.random.RandomState(seed)
    kq, ks = j_quantize_kv_rows(jnp.asarray(
        rng.randn(L, B, M, H, DH).astype(np.float32)))
    vq, vs = j_quantize_kv_rows(jnp.asarray(
        rng.randn(L, B, M, H, DH).astype(np.float32)))
    qw = rng.randn(B, H, Q, DH).astype(np.float32)
    bias = rng.randn(B, H, Q, M).astype(np.float32)
    bias[..., 3] = tf.NEG_INF                 # one banned ring slot
    bias[1, 2, :, BLOCK:] = tf.NEG_INF        # a block whose slots are all banned
    return [np.asarray(a) for a in (kq, vq, ks, vs)] + [qw, bias]


def _assert_close(got, ref):
    o, m, l = (np.asarray(x) for x in got)
    o_r, m_r, l_r = (np.asarray(x) for x in ref)
    m, m_r = m.reshape(o.shape[:-1]), m_r.reshape(o.shape[:-1])
    l, l_r = l.reshape(o.shape[:-1]), l_r.reshape(o.shape[:-1])
    np.testing.assert_allclose(m, m_r, rtol=0, atol=TOL)
    np.testing.assert_allclose(l / l_r, np.ones_like(l_r), rtol=0, atol=TOL)
    np.testing.assert_allclose(o / l[..., None], o_r / l_r[..., None],
                               rtol=0, atol=TOL)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def test_int8_decode_plain_matches_pallas():
    """K6: the q == 1 kernel on an int8 cache with [L, B, M, H] scales."""
    kq, vq, ks, vs, qw, bias = _int8_inputs(0, 1)
    qw, bias = qw[:, :, 0], bias[:, :, 0]
    ref = jf.flash_ring_decode(
        *(jnp.asarray(a) for a in (kq, vq, qw, bias)),
        jnp.array(1, jnp.int32), jnp.asarray(ks), jnp.asarray(vs),
        n_head=H, d_head=DH, scale=SCALE, block_m=BLOCK, interpret=True)
    got = tf.flash_ring_decode_plain(*_t(kq, vq, qw, bias), 1,
                                     *_t(ks, vs), scale=SCALE, block_m=BLOCK)
    assert got[0].shape == (B, H, DH) and got[1].shape == (B, H, 1)
    _assert_close(got, ref)
    # the wrapper takes the plain route for CPU tensors
    _assert_close(tf.flash_ring_decode(*_t(kq, vq, qw, bias), 1,
                                       *_t(ks, vs), scale=SCALE), ref)


@pytest.mark.parametrize("Q", [2, 19, 32])
@pytest.mark.parametrize("oracle", ["ap", "ap_compact", "per_head"])
def test_int8_prime_plain_matches_pallas(Q, oracle):
    """K7 against the all-pairs int8 kernel (both variants) and K8 against
    the per-head int8 kernel, whose scales arrive [L, B, H, M]."""
    kq, vq, ks, vs, qw, bias = _int8_inputs(Q, Q)
    args = (*(jnp.asarray(a) for a in (kq, vq, qw, bias)),
            jnp.array(2, jnp.int32))
    kw = dict(n_head=H, d_head=DH, scale=SCALE, block_m=BLOCK,
              interpret=True)
    ks_t, vs_t = ks.transpose(0, 1, 3, 2), vs.transpose(0, 1, 3, 2)
    if oracle == "per_head":
        ref = jf.flash_ring_prime(*args, jnp.asarray(ks_t),
                                  jnp.asarray(vs_t), **kw)
        got = tf.flash_ring_prime_plain(*_t(kq, vq, qw, bias), 2,
                                        *_t(ks_t, vs_t), scale=SCALE,
                                        block_m=BLOCK)
        wrapped = tf.flash_ring_prime(*_t(kq, vq, qw, bias), 2,
                                      *_t(ks_t, vs_t), scale=SCALE)
    else:
        ref = jf.flash_ring_prime_ap(*args, jnp.asarray(ks),
                                     jnp.asarray(vs),
                                     compact=oracle == "ap_compact", **kw)
        got = tf.flash_ring_prime_ap_plain(*_t(kq, vq, qw, bias), 2,
                                           *_t(ks, vs), scale=SCALE,
                                           block_m=BLOCK)
        wrapped = tf.flash_ring_prime_ap(*_t(kq, vq, qw, bias), 2,
                                         *_t(ks, vs), scale=SCALE)
    assert got[0].shape == (B, H, Q, DH) and got[1].shape == (B, H, Q)
    _assert_close(got, ref)
    _assert_close(wrapped, ref)


def test_k8_equals_k7_on_transposed_scales():
    kq, vq, ks, vs, qw, bias = _int8_inputs(5, 7)
    k7 = tf.flash_ring_prime_ap_plain(*_t(kq, vq, qw, bias), 1, *_t(ks, vs),
                                      scale=SCALE, block_m=BLOCK)
    k8 = tf.flash_ring_prime_plain(
        *_t(kq, vq, qw, bias), 1,
        *_t(ks.transpose(0, 1, 3, 2), vs.transpose(0, 1, 3, 2)),
        scale=SCALE, block_m=BLOCK)
    for a, b in zip(k7, k8):
        assert torch.equal(a, b)


# (q sequence of tests/test_kv_cache.py's int8 ring test)
QS = (6, 1, 1, 9, 1, 30, 1, 4, 26, 1)


def _models(flash, weights):
    cfg, jm, params, pnp = jax_tiny(flash, decode_cache_dtype="int8",
                                    decode_weight_dtype=weights)
    pm = port_model(pnp, flash, decode_cache_dtype="int8",
                    decode_weight_dtype=weights)
    if weights:
        params = quantize_decode_weights(params)
        pm.quantize_decode_weights()
    return cfg, jm, params, pm


@pytest.mark.parametrize("flash,weights", [
    ("on", ""), ("off", ""), ("on", "int8"), ("off", "int8"),
    ("on", "int8a8")])
def test_int8_ring_decode_matches_jax(flash, weights):
    cfg, jm, params, pm = _models(flash, weights)
    M = cfg.model.mem_len
    V = cfg.vocab.layout().total_vocab_size
    jc = jm.apply({"params": params}, 2, method=JaxTXL.init_kv_cache_ring)
    assert jc["k"].dtype == jnp.int8
    j_step = jax.jit(lambda p, t, q, c, r: jm.apply(
        {"params": p}, t, q, c, r, method=JaxTXL.decode_rl_kv_ring))
    tc = pm.init_kv_cache_ring(2)
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].shape == (
        cfg.model.n_layer, 2, M, cfg.model.n_head)
    rng = np.random.RandomState(2)
    cursor, flips, worst = 0, 0, 0.0
    for i, q in enumerate(QS):
        tok = rng.randint(0, V, (2, q))
        pos = rng.randint(0, 8, (2, q))
        rk_j = jm.apply({"params": params}, q, method=JaxTXL.precompute_rk)
        lg_j, jc = j_step(params, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jc, rk_j)
        lg_t, tc = pm.decode_rl_kv_ring(torch.as_tensor(tok),
                                        torch.as_tensor(pos), tc,
                                        pm.precompute_rk(q))
        lg_j = np.asarray(lg_j)
        err = np.abs(lg_t.numpy() - lg_j).max() / np.abs(lg_j).max()
        worst = max(worst, err)
        assert err <= LOGIT_TOL, (i, q, err)
        for key in ("k", "v"):
            d = tc[key].numpy().astype(np.int32) - np.asarray(jc[key])
            assert np.abs(d).max() <= 1, (i, q, key)
            flips += int(np.count_nonzero(d))
            np.testing.assert_allclose(
                tc[key + "_scale"].numpy(), np.asarray(jc[key + "_scale"]),
                rtol=1e-5, atol=0, err_msg=f"{i} {q} {key}")
        cursor = (cursor + q) % M
        assert tc["cursor"] == int(jc["cursor"]) == cursor, (i, q)
    assert flips <= MAX_FLIPS, flips
    assert cursor == 16 and worst < LOGIT_TOL     # wrapped: 86 tokens


def test_int8_gate_routes():
    """decode_flash "auto" takes the kernel route only for a CUDA int8
    cache that comes with its scales (never for CPU tensors)."""
    *_, pnp = jax_tiny()
    pm = port_model(pnp, "auto", decode_cache_dtype="int8")
    cache = pm.init_kv_cache_ring(1)
    assert set(cache) == {"k", "v", "k_scale", "v_scale", "cursor"}
    assert not pm.use_kernels(1, cache)
    assert port_model(pnp, "on", decode_cache_dtype="int8").use_kernels(
        19, cache)
    assert not tf.kernels_take(torch.zeros(1, 1, 4, 2, 128,
                                           dtype=torch.int8))


@pytest.mark.parametrize("weights", ["", "int8"])
def test_int8_greedy_chains_match_jax(weights):
    """Five env steps at batch 3 with defer_last over an int8 cache (the
    episode-start prime in chunked ring slices), the decoders built by
    build_decoder_for_env, which quantizes the weights in both packages."""
    from bdm_db1_tpu.eval.decode import build_decoder_for_env as jbuild
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env as tbuild

    _, jm, params, pnp = jax_tiny("on", decode_cache_dtype="int8",
                                  decode_weight_dtype=weights)
    jt, tt = fake_env_datasets(3, 4, 2, episode_len=6)
    primes = episode_primes(jt, 0, 5, 4)
    ref = greedy_chain(jbuild(jm, params, jt[0]), primes, defer=True)
    pm = port_model(pnp, "on", decode_cache_dtype="int8",
                    decode_weight_dtype=weights)
    dec = tbuild(pm, tt[0])
    assert pm.decode_weights_quantized() == bool(weights)
    got = greedy_chain(dec, primes, defer=True)
    for k, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {k}")
