"""The backward of the port's kernel route (bdm_db1_tpu_torch/ops/
flash_rel_attention.py: the autograd Function around K3-K5, here on the CPU
through their plain versions) against the JAX package's custom VJP of
``pallas_rel_attention`` (Pallas kernels in interpret mode) and against
autograd through the port's ``rel_attention``, on the same numpy inputs
and upstream gradient in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.ops import pallas_attention as jp
from bdm_db1_tpu_torch.ops import attention as ta
from bdm_db1_tpu_torch.ops import flash_rel_attention as tk
from tests.torch_port_helpers import one_thread

NAMES = ("dq", "dk", "dv", "drk", "drw", "drr")
# f32 on both sides, the same sums in another order (JAX blockwise with
# row-reversal products, the port over full matrices): each gradient
# within GRAD_RTOL of its largest value. The drw/drr sums run over every
# query row, and drk over up to qlen band entries, so they carry the most
# rounding; 1e-5 of the largest value is still three orders below a wrong
# mask, scale or shift, which moves a gradient by O(1) of its size.
GRAD_RTOL = 1e-5


def _inputs(b, qlen, klen, h, dh, seed=0):
    rng = np.random.RandomState(seed)
    xs = tuple(rng.randn(*s).astype(np.float32) * 0.3 for s in (
        (b, qlen, h, dh), (b, klen, h, dh), (b, klen, h, dh), (klen, h, dh),
        (h, dh), (h, dh)))
    g = np.random.RandomState(seed + 3).randn(b, qlen, h, dh).astype(
        np.float32)
    return xs, g


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _port_grads(fn, xs, g):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = fn(*ts)
    return torch.autograd.grad(out, ts, torch.from_numpy(g))


def _check(got, ref):
    for name, a, b in zip(NAMES, got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.detach().numpy(), b, rtol=0,
            atol=GRAD_RTOL * float(np.abs(b).max()), err_msg=name)


def _rel_attention_grads(xs, g, mem_len, same_length):
    qlen, klen = xs[0].shape[1], xs[1].shape[1]
    mask = (ta.same_length_mask(qlen, klen, mem_len) if same_length
            else ta.causal_mask(qlen, klen))
    return _port_grads(lambda *t: ta.rel_attention(
        *t, mask, compute_dtype=torch.float32), xs, g)


@pytest.mark.parametrize("same_length,qlen,klen,mem_len", [
    (False, 128, 256, 256),
    (False, 256, 384, 384),   # multiple query and key blocks
    (True, 256, 512, 256),    # sliding-window mask
])
def test_plain_backward_matches_pallas_vjp(same_length, qlen, klen, mem_len):
    """The six gradients of the kernel route (plain K4/K5 under the
    autograd Function) against ``jax.grad`` through the Pallas kernels in
    interpret mode (blocks 128; the shapes of tests/test_pallas_attention.py)
    and against autograd through ``rel_attention``."""
    xs, g = _inputs(1, qlen, klen, 2, 128, seed=1)
    scale = 1.0 / 128 ** 0.5

    def loss(*a):
        return (jp.pallas_rel_attention(*a, mem_len, same_length, scale, 128,
                                        128, True) * jnp.asarray(g)).sum()

    ref = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *map(jnp.asarray, xs))
    got = _port_grads(lambda *t: tk.flash_rel_attention(
        *t, mem_len=mem_len, same_length=same_length, scale=scale), xs, g)
    _check(got, ref)
    _check(got, _rel_attention_grads(xs, g, mem_len, same_length))


# delta = rowsum(dO * O) in f32 on both sides: 128 products summed in
# another order, ~1e-7 of the largest row; a wrong row, head or operand
# moves delta by O(1) of its size.
DELTA_RTOL = 1e-6


class _Captured(Exception):
    pass


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("same_length,qlen,klen,mem_len", [
    (False, 128, 256, 256),
    (False, 256, 384, 384),
    (True, 256, 512, 256),
])
def test_plain_delta_matches_jax_delta(monkeypatch, same_length, qlen, klen,
                                       mem_len, dtype):
    """The port's delta [B, H, qlen] (``bwd_delta_plain``, the one the CUDA
    route's preparation computes once for K4 and K5) against the delta that
    ``_pallas_rel_attention_bwd_impl`` hands its dq kernel: the first
    ``pallas_call`` of the backward is stopped and its operands read."""
    xs, g = _inputs(2, qlen, klen, 2, 128, seed=5)
    out = np.random.RandomState(6).randn(2, qlen, 2, 128).astype(np.float32)
    seen = []

    def pallas_call(*_a, **_k):
        def call(*operands):
            seen.append(operands)
            raise _Captured
        return call

    monkeypatch.setattr(jp.pl, "pallas_call", pallas_call)
    jdt = getattr(jnp, dtype)
    stat = jnp.zeros((2 * 2, 1, qlen), jnp.float32)
    with pytest.raises(_Captured):
        jp._pallas_rel_attention_bwd_impl(
            *(jnp.asarray(x, jdt) for x in xs), jnp.asarray(out, jdt), stat,
            stat, jnp.asarray(g, jdt), mem_len=mem_len,
            same_length=same_length, scale=1.0 / 128 ** 0.5, block_q=128,
            block_k=128, interpret=True)
    ref = np.asarray(seen[0][-1]).reshape(2, 2, qlen)   # [bh, 1, qlen]
    tdt = getattr(torch, dtype)
    got = tk.bwd_delta_plain(torch.from_numpy(out).to(tdt),
                             torch.from_numpy(g).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (2, 2, qlen)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=DELTA_RTOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("qlen,mlen", [(100, 256), (300, 512), (257, 256)])
def test_plain_backward_matches_anylen_wrapper(qlen, mlen):
    """Ragged qlen: the port masks the ragged edges where the JAX wrapper
    pads q, k, v and rk; the gradients of the real rows agree."""
    klen = mlen + qlen
    xs, g = _inputs(1, qlen, klen, 2, 128, seed=4)
    scale = 1.0 / 128 ** 0.5

    def loss(*a):
        return (jp.pallas_rel_attention_anylen(*a, mlen, True, scale, 128,
                                               True) * jnp.asarray(g)).sum()

    ref = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *map(jnp.asarray, xs))
    got = _port_grads(lambda *t: tk.flash_rel_attention(
        *t, mem_len=mlen, same_length=True, scale=scale), xs, g)
    _check(got, ref)


@pytest.mark.parametrize("same_length", [False, True])
def test_kernel_route_gradcheck_f64(same_length):
    """Finite differences in f64 against the kernel route's backward, with
    a memory prefix and a ragged query count (5 queries over 9 keys)."""
    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.randn(*s) * 0.5).requires_grad_(True)
          for s in ((2, 5, 2, 4), (2, 9, 2, 4), (2, 9, 2, 4), (9, 2, 4),
                    (2, 4), (2, 4))]
    assert torch.autograd.gradcheck(
        lambda *t: tk.flash_rel_attention(*t, mem_len=6,
                                          same_length=same_length,
                                          scale=0.4),
        xs, eps=1e-6, atol=1e-7)


def test_plain_backward_equals_its_entry_point():
    """``flash_rel_attention_bwd`` on CPU tensors is the plain version, and
    the stats it takes are the forward's."""
    xs, g = _inputs(2, 64, 96, 3, 16, seed=7)
    ts = [torch.from_numpy(x) for x in xs]
    kw = dict(mem_len=64, same_length=True, scale=0.25)
    out, (m, l) = tk.flash_rel_attention(*ts, with_stats=True, **kw)
    got = tk.flash_rel_attention_bwd(*ts, out, m, l, torch.from_numpy(g),
                                     **kw)
    ref = _rel_attention_grads(xs, g, 64, True)
    _check(got, ref)
    assert [t.dtype for t in got] == [torch.float32] * 6
