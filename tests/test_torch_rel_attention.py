"""The port's relative attention (bdm_db1_tpu_torch/ops/attention.py
``rel_attention`` and ops/flash_rel_attention.py, K3's plain version and
gate) against the JAX package's: ``rel_attention`` and the Pallas kernel in
interpret mode, on the same numpy inputs in f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.ops import attention as ja
from bdm_db1_tpu.ops import pallas_attention as jp
from bdm_db1_tpu_torch.ops import attention as ta
from bdm_db1_tpu_torch.ops import flash_rel_attention as tk
from tests.torch_port_helpers import one_thread

# f32 on both sides, the same arithmetic in another summation order: a few
# f32 ulps of outputs of size ~1 (the JAX tests hold the Pallas kernel to
# its XLA path at 2e-4; the port holds tighter).
OUT_TOL = 1e-5
# the row max is one score, computed from the same f32 products
M_TOL = 1e-5
# l sums up to klen terms <= 1, blockwise in JAX and at once here
L_RTOL = 1e-5


def _inputs(b, qlen, klen, h, dh, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32) * 0.3 for s in (
        (b, qlen, h, dh), (b, klen, h, dh), (b, klen, h, dh), (klen, h, dh),
        (h, dh), (h, dh)))


def _t(xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _j(xs):
    return tuple(jnp.asarray(x) for x in xs)


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("same_length", [False, True])
@pytest.mark.parametrize("qlen,klen,mem_len", [(16, 16, 16), (12, 40, 28),
                                               (20, 52, 16)])
def test_rel_attention_matches_jax(same_length, qlen, klen, mem_len):
    xs = _inputs(2, qlen, klen, 3, 8, seed=qlen)
    jmask = (ja.same_length_mask(qlen, klen, mem_len) if same_length
             else ja.causal_mask(qlen, klen))
    tmask = (ta.same_length_mask(qlen, klen, mem_len) if same_length
             else ta.causal_mask(qlen, klen))
    ref = ja.rel_attention(*_j(xs), jmask, compute_dtype=jnp.float32)
    got = ta.rel_attention(*_t(xs), tmask, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=OUT_TOL)


def _check_stats(out, m, l, ref_out, ref_m, ref_l):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0,
                               atol=OUT_TOL)
    b, qlen = out.shape[:2]
    h = out.shape[2]
    # JAX stats are [B*H, 1, qlen]
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m).reshape(b, h, qlen),
                               rtol=0, atol=M_TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(ref_l).reshape(b, h, qlen),
                               rtol=L_RTOL)


@pytest.mark.parametrize("same_length", [False, True])
@pytest.mark.parametrize("qlen,klen,mem_len", [
    (256, 256, 256), (128, 384, 256), (512, 512, 512),
])
def test_k3_plain_matches_pallas_kernel(same_length, qlen, klen, mem_len):
    """(out, m, l) of K3's plain version against the Pallas kernel with
    stats, blocks 128 (the shapes of tests/test_pallas_attention.py)."""
    xs = _inputs(2, qlen, klen, 2, 128)
    scale = 1.0 / 128 ** 0.5
    ref_out, (ref_m, ref_l) = jp._pallas_rel_attention_fwd_impl(
        *_j(xs), mem_len=mem_len, same_length=same_length, scale=scale,
        block_q=128, block_k=128, interpret=True, with_stats=True)
    out, (m, l) = tk.flash_rel_attention(
        *_t(xs), mem_len=mem_len, same_length=same_length, scale=scale,
        with_stats=True)
    _check_stats(out, m, l, ref_out, ref_m, ref_l)


@pytest.mark.parametrize("qlen,mlen", [(100, 256), (300, 512), (257, 256)])
def test_k3_plain_matches_anylen_wrapper(qlen, mlen):
    """Ragged qlen: the port masks the ragged edges where the JAX wrapper
    pads q, k, v and rk."""
    klen = mlen + qlen
    assert tk.pallas_anylen_applicable(qlen, klen, 128)
    xs = _inputs(1, qlen, klen, 2, 128, seed=4)
    scale = 1.0 / 128 ** 0.5
    ref = jp.pallas_rel_attention_anylen(*_j(xs), mlen, True, scale, 128,
                                         True)
    got = tk.flash_rel_attention(*_t(xs), mem_len=mlen, same_length=True,
                                 scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=OUT_TOL)


def test_k3_plain_equals_rel_attention_at_tiny_head_dim():
    """The kernel route's plain form and ``rel_attention`` compute one
    function (shapes the model's tiny tests reach, Dh 16)."""
    qlen, klen, mem_len = 64, 576, 512
    xs = _t(_inputs(2, qlen, klen, 4, 16, seed=9))
    for same_length in (False, True):
        mask = (ta.same_length_mask(qlen, klen, mem_len) if same_length
                else ta.causal_mask(qlen, klen))
        ref = ta.rel_attention(*xs, mask, compute_dtype=torch.float32)
        got = tk.flash_rel_attention(*xs, mem_len=mem_len,
                                     same_length=same_length,
                                     scale=1.0 / 16 ** 0.5)
        torch.testing.assert_close(got, ref, rtol=0, atol=OUT_TOL)


def test_gate_matches_jax_applicability():
    grid = [(q, m + q) for q in (1, 8, 63, 64, 100, 128, 256, 300, 512, 513,
                                 1000, 1024, 2048)
            for m in (0, 64, 256, 512, 1024)]
    for qlen, klen in grid:
        assert tk.pallas_applicable(qlen, klen) == jp.pallas_applicable(
            qlen, klen), (qlen, klen)
        assert (tk.pallas_anylen_applicable(qlen, klen)
                == jp.pallas_anylen_applicable(qlen, klen)), (qlen, klen)
        assert tk.kernel_route_applicable(qlen, klen) == (
            jp.pallas_applicable(qlen, klen)
            or jp.pallas_anylen_applicable(qlen, klen)), (qlen, klen)


# (config overrides, attention_impl, route on "cpu", route on "cuda"):
# "auto" takes the CUDA kernels only inside their contract (bf16, d_head
# 128); "pallas" forces the route whatever the model; "xla" never takes it
GATE_CASES = [
    (dict(n_embed=256, n_head=2), "xla", False, False),
    (dict(n_embed=256, n_head=2), "pallas", True, True),
    (dict(n_embed=256, n_head=2), "auto", False, True),
    ({}, "auto", False, False),                              # d_head 16
    (dict(n_embed=256, n_head=2, dtype="float32"), "auto", False, False),
    ({}, "pallas", True, True),
    (dict(n_embed=256, n_head=2, dtype="float32"), "pallas", True, True),
]


@pytest.mark.parametrize("overrides,impl,cpu,cuda", GATE_CASES)
def test_model_gate_follows_attention_impl(overrides, impl, cpu, cuda):
    from bdm_db1_tpu_torch.core.config import db1_tiny
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel

    cfg = db1_tiny(attention_impl=impl, **overrides).model
    assert use_rel_kernel(cfg, 1024, 1024, "cpu") is cpu
    assert use_rel_kernel(cfg, 1024, 1024, "cuda") is cuda
    # shapes outside the JAX kernel's reach never take the route
    assert not use_rel_kernel(cfg, 64, 64, "cuda")


def test_model_gate_takes_flagship_kernels():
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel

    cfg = db1_1p2b().model
    assert cfg.attention_impl == "auto" and cfg.d_head == 128
    assert use_rel_kernel(cfg, 1024, 1024, "cuda")
    assert not use_rel_kernel(cfg, 1024, 1024, "cpu")


def test_k3_route_passes_gradients():
    """With grad mode on, gradients flow through the kernel route to every
    input (the backward's agreement is held in
    tests/test_torch_rel_attention_bwd.py); under no_grad nothing is
    recorded."""
    xs = _t(_inputs(1, 64, 64, 1, 128))
    ins = [x.clone().requires_grad_(True) for x in xs]
    kw = dict(mem_len=64, same_length=False, scale=0.1)
    out = tk.flash_rel_attention(*ins, **kw)
    grads = torch.autograd.grad(out.sum(), ins)
    assert all(g.shape == x.shape and torch.isfinite(g).all()
               and g.abs().max() > 0 for g, x in zip(grads, ins))
    with torch.no_grad():
        assert not tk.flash_rel_attention(*ins, **kw).requires_grad
