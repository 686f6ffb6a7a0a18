"""int8 trunk weights of the port (bdm_db1_tpu_torch/ops/quant_matmul.py)
against the JAX package's ops/quant_matmul.py on the CPU, from the same
numpy inputs:

- ``quantize_weight``: int8 values and scales equal exactly (both divide in
  f32 and round half to even), in the transposed [N, K] layout; the port's
  ``TransformerXL.quantize_decode_weights`` gives the JAX quantized tree's
  ints and scales.
- plain K9 against the Pallas ``quant_matmul`` in interpret mode, at block
  sizes that force several k and n blocks: 1e-5 in f32 (the JAX package's
  own bar, tests/test_quant_matmul.py), and in bf16 activations 1e-5 of the
  largest output (both sum exact bf16 x bf16 products in f32).
- ``w8a8_matmul`` against JAX's: 1e-5; its int32 product is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.models.transformer_xl import quantize_decode_weights
from bdm_db1_tpu.ops import quant_matmul as jq
from bdm_db1_tpu_torch.ops import quant_matmul as tq
from torch_port_helpers import jax_tiny, one_thread, port_model, to_numpy

TOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _weight(seed, K, N, zero_col=True):
    w = np.random.RandomState(seed).randn(K, N).astype(np.float32) * 0.05
    if zero_col:
        w[:, 3] = 0.0        # an all-zero output channel: scale 1.0
    return w


def test_quantize_weight_matches_jax():
    w = _weight(0, 64, 48)
    wq_j, s_j = jq.quantize_weight(jnp.asarray(w))
    wq_t, s_t = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    assert wq_t.dtype == torch.int8 and wq_t.shape == (48, 64)
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j).T)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert s_t[3] == 1.0 and not wq_t[3].any()


def test_quantize_decode_weights_matches_jax():
    """The port quantizes exactly qkv_net, o_net, CoreNet.0 and CoreNet.2
    of every layer, to the JAX tree's ints and scales (transposed), and
    leaves r_net, the embeddings and the LayerNorms as they were."""
    cfg, _, params, pnp = jax_tiny()
    qnp = to_numpy(quantize_decode_weights(params))
    pm = port_model(pnp, decode_weight_dtype="int8")
    r_net = pm.h[0].dec_attn.r_net.weight.clone()
    pm.quantize_decode_weights()
    pm.quantize_decode_weights()            # idempotent
    assert pm.decode_weights_quantized()
    sd = pm.state_dict()
    paths = {"dec_attn.qkv_net": ("attn", "qkv_net"),
             "dec_attn.o_net": ("attn", "o_net"),
             "pos_ff.CoreNet.0": ("ff", "wi"),
             "pos_ff.CoreNet.2": ("ff", "wo")}
    for i in range(cfg.model.n_layer):
        for name, (grp, leaf) in paths.items():
            node = qnp["layers"][grp][leaf]
            np.testing.assert_array_equal(
                sd[f"h.{i}.{name}.weight_q"].numpy(), node["kernel"][i].T)
            np.testing.assert_array_equal(
                sd[f"h.{i}.{name}.weight_scale"].numpy(),
                node["kernel_scale"][i])
            assert f"h.{i}.{name}.weight" not in sd
    assert torch.equal(pm.h[0].dec_attn.r_net.weight, r_net)
    assert sd["word_embedding.weight"].dtype == torch.float32


@pytest.mark.parametrize("R,K,N,bm,bk,bn", [
    (8, 64, 96, 1024, 16, 32),      # 4 k blocks x 3 n blocks
    (100, 64, 96, 20, 32, 32),      # ragged rows over several m blocks
])
def test_quant_matmul_plain_matches_pallas(R, K, N, bm, bk, bn):
    rng = np.random.RandomState(R)
    x = rng.randn(R, K).astype(np.float32)
    wq, s = jq.quantize_weight(jnp.asarray(_weight(R + 1, K, N)))
    ref = np.asarray(jq.quant_matmul(jnp.asarray(x), wq, s, block_m=bm,
                                     block_k=bk, block_n=bn,
                                     interpret=True))
    w_t = torch.from_numpy(np.asarray(wq).T.copy())
    s_t = torch.tensor(np.asarray(s))
    got = tq.quant_matmul_plain(torch.from_numpy(x), w_t, s_t)
    assert got.dtype == torch.float32 and got.shape == (R, N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    # the wrapper takes the plain route for CPU tensors
    wrapped = tq.quant_matmul(torch.from_numpy(x), w_t, s_t)
    np.testing.assert_allclose(wrapped.numpy(), ref, rtol=TOL, atol=TOL)


def test_quant_matmul_bf16_activations_match_pallas():
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(12, 64), jnp.bfloat16)
    wq, s = jq.quantize_weight(jnp.asarray(_weight(3, 64, 32)))
    ref = np.asarray(jq.quant_matmul(x, wq, s, block_k=16, block_n=16,
                                     interpret=True))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    got = tq.quant_matmul(xt, torch.from_numpy(np.asarray(wq).T.copy()),
                          torch.tensor(np.asarray(s)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


def test_w8a8_matmul_matches_jax():
    rng = np.random.RandomState(11)
    x = rng.randn(12, 64).astype(np.float32)
    x[5] = 0.0                             # an all-zero row stays zero
    wq, s = jq.quantize_weight(jnp.asarray(_weight(12, 64, 96)))
    ref = np.asarray(jq.w8a8_matmul(jnp.asarray(x), wq, s))
    w_t = torch.from_numpy(np.asarray(wq).T.copy())
    got = tq.w8a8_matmul(torch.from_numpy(x), w_t,
                         torch.tensor(np.asarray(s)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    assert not got[5].any()
    # the int8 x int8 -> int32 product is the exact integer product
    xq, _ = tq.quantize_rows(torch.from_numpy(x))
    acc = tq.int8_matmul(xq, w_t)
    assert acc.dtype == torch.int32
    exact = xq.numpy().astype(np.int64) @ np.asarray(wq).astype(np.int64)
    np.testing.assert_array_equal(acc.numpy(), exact)
    # the card's route: torch._int_mm with the rows padded past 16
    np.testing.assert_array_equal(tq.int_mm_padded(xq, w_t).numpy(), exact)


def test_cuda_route_refuses_what_the_kernel_does_not_take():
    """A non-CPU tensor never reaches the plain version: a shape the K9
    kernel does not take is refused before any build or launch."""
    x = torch.zeros(4, 30, device="meta")
    w = torch.zeros(8, 30, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="K9 kernel takes"):
        tq.quant_matmul(x, w, torch.zeros(8, device="meta"))


# K9's launch plan (plain Python, held here; the kernel runs it on the
# card): the 16 serve shapes (rows of the int8 serve x the four trunk
# matrices of db1_1p2b) and the edge shapes chip_smoke also checks.
_TRUNK_KN = [(2048, 6144), (2048, 2048), (2048, 8192), (4096, 2048)]
_PLAN_SHAPES = ([(R, K, N) for R in (56, 1064, 1456, 14336)
                 for K, N in _TRUNK_KN]
                + [(R, K, N) for R in (1, 8, 57, 64, 65, 200)
                   for K, N in ((96, 200), (4128, 2056))])


def _covered_once(extent: int, tile: int, tiles: int) -> bool:
    hits = np.zeros(extent, np.int64)
    for t in range(tiles):
        hits[t * tile:(t + 1) * tile] += 1
    return bool((hits == 1).all()) and (tiles - 1) * tile < extent


@pytest.mark.parametrize("R,K,N", _PLAN_SHAPES)
@pytest.mark.parametrize("sms", [tq.H100_SMS])
def test_quant_matmul_plan(R, K, N, sms):
    plan = tq.plan_quant_matmul(R, K, N, sms)
    # the CTA tiles cover [R, N] exactly once: rows by bn, columns by bm
    assert (plan.bn, plan.bm) in tq.QMM_TILES
    assert _covered_once(R, plan.bn, plan.x_tiles)
    assert _covered_once(N, plan.bm, plan.w_tiles)
    # wgmma's n: a multiple of 8, at most 256
    assert plan.bn % 8 == 0 and plan.bn <= 256
    # K in QMM_BK steps, the splits cover the steps once, none empty
    bk = tq.QMM_BK
    assert plan.nk * bk >= K > (plan.nk - 1) * bk
    steps = [range(s * plan.kps, min(plan.nk, (s + 1) * plan.kps))
             for s in range(plan.split)]
    assert all(len(r) > 0 for r in steps)
    assert sorted(k for r in steps for k in r) == list(range(plan.nk))
    assert plan.ctas == plan.w_tiles * plan.x_tiles * plan.split
    # the one integer the C entry point decodes
    code = tq.plan_code(plan)
    assert (code & 511, code >> 9 & 511, code >> 18 & 15, code >> 22) == (
        plan.bn, plan.bm, plan.split, plan.kps)
    if R <= tq.QMM_SMALL_R:
        # one x tile; the splits fill the SMs unless S is at the cap
        assert plan.x_tiles == 1
        assert plan.ctas >= sms or plan.split == tq.split_cap(R, K)
    else:
        assert plan.split == 1
    assert plan.split <= tq.split_cap(R, K) <= tq.QMM_SPLIT_CAP
    # a split keeps QMM_MIN_WAY_STEPS steps in each of the CTA's ways
    if plan.split > 1:
        assert plan.kps >= tq.QMM_WAYS * tq.QMM_MIN_WAY_STEPS


def test_quant_matmul_plan_picks_the_least_padding():
    """The serve's row counts: 56 is one n = 56 tile (no padding), the
    1064-row prime 8 tiles of 136, the 1456-row prompt tail 7 of 208, a
    256-token prompt slice 56 of 256; at 56 rows only CoreNet.2 (K 4096)
    has the K steps to split (2 splits of 32 steps), the rest run one CTA
    a 64-row tile."""
    got = {R: tq.plan_quant_matmul(R, 2048, 2048) for R in (56, 1064, 1456,
                                                             14336)}
    assert {R: (p.bn, p.x_tiles) for R, p in got.items()} == {
        56: (56, 1), 1064: (136, 8), 1456: (208, 7), 14336: (256, 56)}
    assert got[56].split == 1
    assert tq.plan_quant_matmul(56, 4096, 2048).split == 2
    assert tq.plan_quant_matmul(56, 2048, 8192).split == 1
