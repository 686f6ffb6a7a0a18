"""The port's TransformerXL.decode_rl_kv_ring against the JAX package's,
from the same weights (db1_tiny, f32, CPU), with decode_flash "on" (the
kernels' plain versions against the Pallas kernels in interpret mode) and
"off" (the plain ring branches): logits within 2e-4 (tests/test_parity.py's
bar), the cache within 1e-5 and the cursor equal after every forward; and
in bf16, the port's logits against the JAX package's bf16 path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.core.config import db1_tiny
from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
from bdm_db1_tpu_torch.core import config as port_config
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL as PortTXL
from bdm_db1_tpu_torch.train.convert import load_jax_params
from torch_port_helpers import jax_tiny, one_thread, port_model


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


# (label, q): a 38-token prompt (> mem_len 32) primed as two ring slices, a
# 19-token observation prime, a q == 1 step, then a 19-token prime that
# wraps the cursor (26 -> 13)
STEPS = [("prompt slice 1", 19), ("prompt slice 2", 19), ("19-token prime", 19),
         ("q == 1", 1), ("wrapping prime", 19)]


@pytest.mark.parametrize("flash", ["on", "off"])
def test_ring_decode_matches_jax(flash):
    cfg, jm, params, pnp = jax_tiny(flash)
    pm = port_model(pnp, flash)
    M = cfg.model.mem_len
    V = cfg.vocab.layout().total_vocab_size
    jc = jm.apply({"params": params}, 3, method=JaxTXL.init_kv_cache_ring)
    # jitted so repeated shapes reuse one program
    j_step = jax.jit(lambda p, t, q, c, r: jm.apply(
        {"params": p}, t, q, c, r, method=JaxTXL.decode_rl_kv_ring))
    tc = pm.init_kv_cache_ring(3)
    rng = np.random.RandomState(7)
    cursor = 0
    for label, q in STEPS:
        tok = rng.randint(0, V, (3, q))
        pos = rng.randint(0, 8, (3, q))
        rk_j = jm.apply({"params": params}, q, method=JaxTXL.precompute_rk)
        rk_t = pm.precompute_rk(q)
        np.testing.assert_allclose(rk_t.numpy(), np.asarray(rk_j), rtol=0,
                                   atol=1e-6)
        lg_j, jc = j_step(params, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jc, rk_j)
        lg_t, tc = pm.decode_rl_kv_ring(torch.as_tensor(tok),
                                        torch.as_tensor(pos), tc, rk_t)
        assert lg_t.shape == (3, cfg.vocab.layout().padded_vocab_size)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=0,
                                   atol=2e-4, err_msg=label)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       rtol=0, atol=1e-5, err_msg=label)
        cursor = (cursor + q) % M
        assert tc["cursor"] == int(jc["cursor"]) == cursor, label
    assert cursor == 13     # the last prime wrapped


def test_gate_routes():
    """decode_flash: "off" never takes the kernel route, "on" takes it for
    1 <= q <= 32, "auto" only where the CUDA kernels take the cache."""
    *_, pnp = jax_tiny()
    cache = {"k": torch.zeros(2, 1, 32, 4, 16)}
    assert not port_model(pnp, "off").use_kernels(1, cache)
    on = port_model(pnp, "on")
    assert on.use_kernels(1, cache) and on.use_kernels(32, cache)
    assert not on.use_kernels(33, cache)
    assert not port_model(pnp, "auto").use_kernels(1, cache)


def _logit_chain(step, V, seed=7):
    """Logits of the STEPS forwards, from one stream of random tokens."""
    rng = np.random.RandomState(seed)
    out = []
    for _, q in STEPS:
        out.append(step(rng.randint(0, V, (3, q)), rng.randint(0, 8, (3, q))))
    return out


def _jax_chain(dtype, flash, params, V):
    cfg = db1_tiny()
    cfg.model.dtype = dtype
    cfg.model.decode_flash = flash
    jm = JaxTXL(cfg.model, cfg.vocab, cfg.vision)
    run = jax.jit(lambda p, t, q, c, r: jm.apply(
        {"params": p}, t, q, c, r, method=JaxTXL.decode_rl_kv_ring))
    cache = [jm.apply({"params": params}, 3, method=JaxTXL.init_kv_cache_ring)]

    def step(tok, pos):
        rk = jm.apply({"params": params}, tok.shape[1],
                      method=JaxTXL.precompute_rk)
        lg, cache[0] = run(params, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(pos, jnp.int32), cache[0], rk)
        return np.asarray(lg, np.float32)
    return _logit_chain(step, V)


@pytest.mark.parametrize("flash", ["on", "off"])
def test_ring_decode_bf16_matches_jax_bf16(flash):
    """db1_tiny in bf16, weights rounded to bf16 so both packages start
    from the same values. Two bf16 computations round at different points,
    so they differ by the bf16 floor itself (each is 2e-3..3e-3 of the
    largest logit from its own f32 result here): the port is held within
    1e-2 of the largest logit of JAX's bf16 logits, and its distance from
    f32 within twice JAX's own."""
    *_, pnp = jax_tiny()
    p16 = jax.tree.map(lambda a: np.asarray(
        jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), pnp)
    params = jax.tree.map(jnp.asarray, p16)
    pcfg = port_config.db1_tiny(dtype="bfloat16", param_dtype="bfloat16",
                                decode_flash=flash)
    pm = PortTXL(pcfg.model, pcfg.vocab, device="cpu")
    load_jax_params(pm, p16)
    V = pcfg.vocab.layout().total_vocab_size
    cache = [pm.init_kv_cache_ring(3)]

    def port_step(tok, pos):
        lg, cache[0] = pm.decode_rl_kv_ring(
            torch.as_tensor(tok), torch.as_tensor(pos), cache[0],
            pm.precompute_rk(tok.shape[1]))
        return lg.numpy()

    port = _logit_chain(port_step, V)
    j16 = _jax_chain("bfloat16", flash, params, V)
    j32 = _jax_chain("float32", "off", params, V)
    for (label, _), p, j, f in zip(STEPS, port, j16, j32):
        top = np.abs(f).max()
        assert np.abs(p - j).max() <= 1e-2 * top, label
        assert np.abs(p - f).max() <= 2 * np.abs(j - f).max(), label
