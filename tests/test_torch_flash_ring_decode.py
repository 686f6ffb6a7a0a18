"""The plain PyTorch versions of the ring-decode kernels (K1 q == 1, K2
2 <= Q <= 32, bdm_db1_tpu_torch/ops/flash_ring_decode.py) against the JAX
Pallas kernels in interpret mode, and the online-softmax merges against
the JAX ones. Same inputs from a numpy seed; tolerance 1e-5 abs on the
normalised output o/l, on l relative to it, and on m (f32 throughout, so
the only differences are summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.ops import flash_ring_decode as jf
from bdm_db1_tpu_torch.ops import flash_ring_decode as tf
from torch_port_helpers import one_thread

TOL = 1e-5
L, B, M, H, DH = 3, 2, 16, 4, 8
BLOCK = 8           # two key blocks: M is not the block size
SCALE = 1.0 / np.sqrt(DH)


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _inputs(seed, Q):
    rng = np.random.RandomState(seed)
    k = rng.randn(L, B, M, H, DH).astype(np.float32)
    v = rng.randn(L, B, M, H, DH).astype(np.float32)
    qw = rng.randn(B, H, Q, DH).astype(np.float32)
    bias = rng.randn(B, H, Q, M).astype(np.float32)
    bias[..., 3] = tf.NEG_INF                 # one banned ring slot
    bias[1, 2, :, BLOCK:] = tf.NEG_INF        # a block whose slots are all banned
    return k, v, qw, bias


def _assert_close(got, ref):
    o, m, l = (np.asarray(x) for x in got)
    o_r, m_r, l_r = (np.asarray(x) for x in ref)
    # K1 returns m, l as [B, H, 1]; K2 as [B, H, Q]
    m, m_r = m.reshape(o.shape[:-1]), m_r.reshape(o.shape[:-1])
    l, l_r = l.reshape(o.shape[:-1]), l_r.reshape(o.shape[:-1])
    np.testing.assert_allclose(m, m_r, rtol=0, atol=TOL)
    np.testing.assert_allclose(l / l_r, np.ones_like(l_r), rtol=0, atol=TOL)
    np.testing.assert_allclose(o / l[..., None], o_r / l_r[..., None],
                               rtol=0, atol=TOL)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_decode_plain_matches_pallas():
    k, v, qw, bias = _inputs(0, 1)
    qw, bias = qw[:, :, 0], bias[:, :, 0]
    ref = jf.flash_ring_decode(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(qw), jnp.asarray(bias),
        jnp.array(1, jnp.int32), n_head=H, d_head=DH, scale=SCALE,
        block_m=BLOCK, interpret=True)
    got = tf.flash_ring_decode_plain(*_t(k, v, qw, bias), 1, scale=SCALE,
                                     block_m=BLOCK)
    assert got[0].shape == (B, H, DH) and got[1].shape == (B, H, 1)
    _assert_close(got, ref)
    # the wrapper takes the plain route for CPU tensors
    wrapped = tf.flash_ring_decode(*_t(k, v, qw, bias), 1, scale=SCALE)
    _assert_close(wrapped, ref)


@pytest.mark.parametrize("Q", [2, 19, 32])
@pytest.mark.parametrize("oracle", ["ap", "ap_compact", "per_head"])
def test_prime_plain_matches_pallas(Q, oracle):
    k, v, qw, bias = _inputs(Q, Q)
    args = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(qw),
            jnp.asarray(bias), jnp.array(2, jnp.int32))
    kw = dict(n_head=H, d_head=DH, scale=SCALE, block_m=BLOCK,
              interpret=True)
    if oracle == "per_head":
        ref = jf.flash_ring_prime(*args, **kw)
    else:
        ref = jf.flash_ring_prime_ap(*args, compact=oracle == "ap_compact",
                                     **kw)
    got = tf.flash_ring_prime_ap_plain(*_t(k, v, qw, bias), 2, scale=SCALE,
                                    block_m=BLOCK)
    assert got[0].shape == (B, H, Q, DH) and got[1].shape == (B, H, Q)
    _assert_close(got, ref)


@pytest.mark.parametrize("M_ragged", [12, 21])
def test_plain_ragged_blocks(M_ragged):
    """A last key block shorter than the others (as the CUDA kernels' last
    split can be) gives what one unsplit block gives."""
    rng = np.random.RandomState(M_ragged)
    k = torch.from_numpy(rng.randn(2, 2, M_ragged, H, DH).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 2, M_ragged, H, DH).astype(np.float32))
    qw = torch.from_numpy(rng.randn(2, H, 5, DH).astype(np.float32))
    bias = torch.from_numpy(rng.randn(2, H, 5, M_ragged).astype(np.float32))
    bias[..., :BLOCK] = tf.NEG_INF
    split = tf.flash_ring_prime_ap_plain(k, v, qw, bias, 1, scale=SCALE,
                                      block_m=BLOCK)
    whole = tf.flash_ring_prime_ap_plain(k, v, qw, bias, 1, scale=SCALE,
                                      block_m=M_ragged)
    _assert_close(split, whole)


# bf16 compute (the serves'): both sides round p * v_scale to bf16 against
# the same block maxima, from f32 scores summed in another order, so now
# and then one p rounds the other way and moves its query row by ~1e-4 of
# the largest output. At most MAX_FLIP_ROWS rows may differ beyond TOL, by
# at most FLIP_TOL of the largest output (chip_smoke's kernel limit); a
# softmax block of another size than the kernel's moves every row.
MAX_FLIP_ROWS = 4
FLIP_TOL = 2e-3


@pytest.mark.parametrize("Q", [19, 26])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_prime_plain_at_kernel_split_matches_pallas(Q, cache):
    """The plain prime at the CUDA kernel's own split (``tf.K2_SPLIT``
    keys a softmax block: what chip_smoke holds the kernel to on the card)
    on a bf16 cache and on an int8 one with its scales (bf16 queries, as
    the serves run them), M ragged against the split. The JAX kernel takes
    whole blocks only, so its cache is padded to the next split with keys
    of bias -inf (probability 0, as the plain version pads its last
    block); both sides then round p to bf16 against the same block
    maxima."""
    from bdm_db1_tpu.models.transformer_xl import quantize_kv_rows as jq

    Lk, Bk, Mk, Hk, Dk = 2, 2, 200, 2, 32
    Mp = -(-Mk // tf.K2_SPLIT) * tf.K2_SPLIT
    scale = 1.0 / np.sqrt(Dk)
    rng = np.random.RandomState(Q)
    kv = [rng.randn(Lk, Bk, Mk, Hk, Dk).astype(np.float32) for _ in range(2)]
    qw = rng.randn(Bk, Hk, Q, Dk).astype(np.float32)
    bias = rng.randn(Bk, Hk, Q, Mk).astype(np.float32)
    bias[..., 3] = tf.NEG_INF                      # one banned ring slot
    bias[1, 1, :, tf.K2_SPLIT:] = tf.NEG_INF       # an all-banned split
    scales = []
    if cache == "int8":
        (kq, ks), (vq, vs) = (jq(jnp.asarray(x)) for x in kv)
        kv, scales = [np.array(kq), np.array(vq)], [np.array(ks),
                                                    np.array(vs)]
    jdt, tdt = jnp.bfloat16, torch.bfloat16        # the compute dtype
    pad = Mp - Mk
    kv_p = [np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
            for x in kv]
    scales_p = [np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0)),
                       constant_values=1.0) for x in scales]
    bias_p = np.pad(bias, ((0, 0), (0, 0), (0, 0), (0, pad)),
                    constant_values=-np.inf)

    def jarr(x):
        return jnp.asarray(x) if x.dtype == np.int8 else jnp.asarray(x, jdt)

    ref = jf.flash_ring_prime_ap(
        *(jarr(x) for x in kv_p), jnp.asarray(qw, jdt), jnp.asarray(bias_p),
        jnp.array(1, jnp.int32), *(jnp.asarray(x) for x in scales_p),
        n_head=Hk, d_head=Dk, scale=scale, block_m=tf.K2_SPLIT,
        interpret=True)

    def tarr(x):
        t = torch.from_numpy(x)
        return t if x.dtype == np.int8 else t.to(tdt)

    got = tf.flash_ring_prime_ap_plain(
        *(tarr(x) for x in kv), tarr(qw), torch.from_numpy(bias), 1,
        *(torch.from_numpy(x) for x in scales), scale=scale,
        block_m=tf.K2_SPLIT)
    assert got[0].shape == (Bk, Hk, Q, Dk) and got[1].shape == (Bk, Hk, Q)
    o, m, l = (np.asarray(x, np.float32) for x in got)
    o_r, m_r, l_r = (np.asarray(jnp.asarray(x, jnp.float32)) for x in ref)
    np.testing.assert_allclose(m, m_r, rtol=0, atol=TOL)
    np.testing.assert_allclose(l / l_r, np.ones_like(l_r), rtol=0, atol=TOL)
    out, out_r = o / l[..., None], o_r / l_r[..., None]
    row_err = np.abs(out - out_r).max(-1)
    assert (row_err > TOL).sum() <= MAX_FLIP_ROWS, row_err
    assert row_err.max() <= FLIP_TOL * np.abs(out_r).max(), row_err.max()


def test_combine_self_column_matches_jax():
    rng = np.random.RandomState(5)
    o = rng.randn(B, H, DH).astype(np.float32)
    m = rng.randn(B, H, 1).astype(np.float32)
    m[0, 1] = tf.NEG_INF                     # a cache part with no live key
    l = rng.rand(B, H, 1).astype(np.float32) + 0.5
    s_x = rng.randn(B, H).astype(np.float32)
    v_x = rng.randn(B, H, DH).astype(np.float32)
    ref = jf.combine_self_column(*(jnp.asarray(x) for x in (o, m, l, s_x,
                                                            v_x)), H, DH)
    got = tf.combine_self_column(*_t(o, m, l, s_x, v_x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_combine_new_columns_matches_jax():
    Q = 5
    rng = np.random.RandomState(6)
    o = rng.randn(B, H, Q, DH).astype(np.float32)
    m = rng.randn(B, H, Q).astype(np.float32)
    l = rng.rand(B, H, Q).astype(np.float32) + 0.5
    s_new = rng.randn(B, H, Q, Q).astype(np.float32)
    s_new[..., np.triu_indices(Q, 1)[0], np.triu_indices(Q, 1)[1]] = \
        tf.NEG_INF
    v_x = rng.randn(B, Q, H, DH).astype(np.float32)
    ref = jf.combine_new_columns(
        *(jnp.asarray(x) for x in (o, m, l, s_new, v_x)),
        compute_dtype=jnp.float32)
    got = tf.combine_new_columns(*_t(o, m, l, s_new, v_x),
                                 compute_dtype=torch.float32)
    assert got.shape == (B, Q, H, DH)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_cuda_route_refuses_what_the_kernel_does_not_take():
    """A CUDA cache the kernels do not take is refused before any launch,
    and a non-CPU, non-CUDA tensor never reaches the plain version."""
    k = torch.zeros(1, 1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA ring-decode kernels take"):
        tf.flash_ring_decode(k, k, torch.zeros(1, 2, 8, device="meta"),
                             torch.zeros(1, 2, 4, device="meta"), 0,
                             scale=SCALE)
    assert not tf.kernels_take(torch.zeros(1, 1, 4, 2, 128))
