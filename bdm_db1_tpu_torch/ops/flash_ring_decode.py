"""Ring-cache decode attention: the CUDA kernels K1/K6 (q == 1, bf16/int8
cache), K2/K7 (2 <= Q <= 32) and K8 (the per-head prime, int8 scales
head-major), their plain PyTorch versions, and the online-softmax merges.

Counterpart of bdm_db1_tpu/ops/flash_ring_decode.py, with its entry names:
``flash_ring_decode`` (K1/K6), ``flash_ring_prime_ap`` (K2/K7) and
``flash_ring_prime`` (K8). Each kernel computes what the Pallas kernel's
wrapper returns, for one layer of the stacked ring cache ``[L, B, M, H, Dh]``:

    s = bf16(qw * bf16(scale)) . k * k_scale + bias   (bias: scaled BD term
                                                   in ring order, NEG_INF at
                                                   banned slots)
    per key block: m_blk = max s, p = exp(s - m_blk), l_blk = sum p,
                   o_blk = sum cdt(p * v_scale) * v
    merged: m = max m_blk, w = exp(m_blk - m), o = sum w o_blk, l = sum w l_blk

and returns the UNNORMALISED ``o`` with ``(m, l)``; :func:`combine_self_column`
and :func:`combine_new_columns` fold in the new tokens' own columns. ``cdt``
is the compute dtype (the query's). With an int8 cache the dequant scales
``[L, B, M, H]`` (K8: ``[L, B, H, M]``) land on the scores and on the PV
operand, never on the cache read and never on ``l``; with an exact-dtype
cache there are no scales (both are 1).

``NEG_INF`` is -1e30, not -inf: a block whose slots are all banned gets
``m_blk = -1e30`` and junk ``(o, l)``, and only its merge weight
``exp(-1e30 - m) = 0`` removes it (with -inf the merge would give NaN).

The wrappers take a tensor's device as the route: CPU tensors run the plain
version, CUDA tensors launch the kernel (csrc/flash_ring_decode.cu, built on
first use) or raise. The kernels take bf16 or int8 (with scales) caches with
a head dim of 128 and bf16 queries; the plain versions take any dtype and
shape. ``LAUNCHES`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bdm_db1_tpu_torch.ops.cuda_build import check_operand, load_library

NEG_INF = -1e30
DEFAULT_BLOCK_M = 512
MAX_PRIME_Q = 32
# what csrc/flash_ring_decode.cu takes (checked against the library on load)
KERNEL_HEAD_DIM = 128
K1_MAX_HEADS = 32
K1_SPLIT = 64          # keys per K1/K6 softmax block (split)
K2_SPLIT = 128         # keys per K2/K7/K8 softmax block (split)

# launches per kernel, counted where the wrapper launches it
LAUNCHES = dict.fromkeys(
    ("flash_ring_decode", "flash_ring_decode_int8", "flash_ring_prime_ap",
     "flash_ring_prime_ap_int8", "flash_ring_prime"), 0)

Tensor = torch.Tensor


# ---- plain versions -------------------------------------------------------

def _scaled(qw: Tensor, scale: float) -> Tensor:
    """Fold 1/sqrt(Dh) into the query in its own dtype, as the kernels do."""
    return qw * torch.tensor(scale, dtype=qw.dtype)


def _attend_blocks(qs: Tensor, k: Tensor, v: Tensor, bias: Tensor,
                   ks: Optional[Tensor], vs: Optional[Tensor],
                   block_m: int) -> Tuple[Tensor, Tensor, Tensor]:
    """qs [B, H, Q, Dh] scaled queries, k/v [B, M, H, Dh] one layer, bias
    [B, H, Q, M] f32, ks/vs [B, M, H] dequant scales or None -> blockwise
    partials o [B, nm, H, Q, Dh], m/l [B, nm, H, Q], then merged. A ragged
    last block is padded with keys of score -inf, which get probability 0."""
    B, M, H, Dh = k.shape
    Q = qs.shape[2]
    bm = min(block_m, M)
    nm = -(-M // bm)
    pad = nm * bm - M
    if ks is None:
        ks = vs = torch.ones(B, M, H, dtype=torch.float32, device=k.device)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        ks = F.pad(ks, (0, 0, 0, pad))
        vs = F.pad(vs, (0, 0, 0, pad))
        bias = F.pad(bias, (0, pad), value=float("-inf"))
    kb = k.reshape(B, nm, bm, H, Dh).float()
    vb = v.reshape(B, nm, bm, H, Dh).float()
    ks_b = ks.float().reshape(B, nm, bm, H).permute(0, 1, 3, 2)[..., None, :]
    vs_b = vs.float().reshape(B, nm, bm, H).permute(0, 1, 3, 2)[..., None, :]
    bias_b = bias.reshape(B, H, Q, nm, bm).permute(0, 3, 1, 2, 4)
    s = torch.einsum("bhqd,bnmhd->bnhqm", qs.float(), kb) * ks_b + bias_b
    m_blk = s.amax(-1)                                       # [B, nm, H, Q]
    p = torch.exp(s - m_blk[..., None])
    l_blk = p.sum(-1)
    # the v scale folds into p on the PV operand only (never into l), then
    # p rounds to the compute dtype before the PV product (f32 accumulation)
    o_blk = torch.einsum("bnhqm,bnmhd->bnhqd",
                         (p * vs_b).to(qs.dtype).float(), vb)
    m_f = m_blk.amax(1)                                      # [B, H, Q]
    w = torch.exp(m_blk - m_f[:, None])
    o_un = torch.einsum("bnhqd,bnhq->bhqd", o_blk, w)
    l_f = (l_blk * w).sum(1)
    return o_un, m_f, l_f


def _layer_scales(k_scale, v_scale, layer):
    if k_scale is None:
        return None, None
    return k_scale[layer], v_scale[layer]


def flash_ring_decode_plain(k_cache: Tensor, v_cache: Tensor, qw: Tensor,
                            bias: Tensor, layer: int,
                            k_scale: Optional[Tensor] = None,
                            v_scale: Optional[Tensor] = None, *,
                            scale: float, block_m: int = DEFAULT_BLOCK_M
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain K1/K6: qw [B, H, Dh], bias [B, H, M], scales [L, B, M, H] ->
    (o [B, H, Dh], m [B, H, 1], l [B, H, 1]), all f32."""
    o, m, l = _attend_blocks(_scaled(qw, scale)[:, :, None], k_cache[layer],
                             v_cache[layer], bias[:, :, None],
                             *_layer_scales(k_scale, v_scale, layer), block_m)
    return o[:, :, 0], m, l


def flash_ring_prime_ap_plain(k_cache: Tensor, v_cache: Tensor, qw: Tensor,
                              bias: Tensor, layer: int,
                              k_scale: Optional[Tensor] = None,
                              v_scale: Optional[Tensor] = None, *,
                              scale: float, block_m: int = DEFAULT_BLOCK_M
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain K2/K7: qw [B, H, Q, Dh], bias [B, H, Q, M], scales
    [L, B, M, H] -> (o [B, H, Q, Dh], m [B, H, Q], l [B, H, Q]), all f32."""
    return _attend_blocks(_scaled(qw, scale), k_cache[layer], v_cache[layer],
                          bias, *_layer_scales(k_scale, v_scale, layer),
                          block_m)


def flash_ring_prime_plain(k_cache: Tensor, v_cache: Tensor, qw: Tensor,
                           bias: Tensor, layer: int,
                           k_scale_t: Optional[Tensor] = None,
                           v_scale_t: Optional[Tensor] = None, *,
                           scale: float, block_m: int = DEFAULT_BLOCK_M
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain K8: :func:`flash_ring_prime_ap_plain` with the scales
    head-major, [L, B, H, M]."""
    ks, vs = _layer_scales(k_scale_t, v_scale_t, layer)
    if ks is not None:
        ks, vs = ks.transpose(1, 2), vs.transpose(1, 2)
    return _attend_blocks(_scaled(qw, scale), k_cache[layer], v_cache[layer],
                          bias, ks, vs, block_m)


# ---- kernels --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("flash_ring_decode")
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bdm_flash_ring_decode.argtypes = [P] * 12 + [I] * 4 + [Fl, I, P]
    lib.bdm_flash_ring_decode.restype = I
    lib.bdm_flash_ring_prime.argtypes = [P] * 12 + [I] * 6 + [Fl, I, P]
    lib.bdm_flash_ring_prime.restype = I
    lib.bdm_cuda_error_string.argtypes = [I]
    lib.bdm_cuda_error_string.restype = ctypes.c_char_p
    for fn, want in (("bdm_head_dim", KERNEL_HEAD_DIM),
                     ("bdm_k1_split", K1_SPLIT), ("bdm_k2_split", K2_SPLIT),
                     ("bdm_k2_max_q", MAX_PRIME_Q)):
        getattr(lib, fn).restype = I
        got = getattr(lib, fn)()
        if got != want:
            raise RuntimeError(f"{fn}() = {got}, the wrapper expects {want}")
    return lib


def kernels_take(k_cache: Tensor, k_scale: Optional[Tensor] = None) -> bool:
    """Whether the CUDA kernels take this stacked cache: bf16, or int8 with
    its dequant scales."""
    dtype_ok = (k_cache.dtype == torch.bfloat16
                or (k_cache.dtype == torch.int8 and k_scale is not None))
    return (k_cache.is_cuda and dtype_ok and k_cache.dim() == 5
            and k_cache.shape[-1] == KERNEL_HEAD_DIM
            and k_cache.shape[-2] <= K1_MAX_HEADS)


def _check_cache(k_cache: Tensor, v_cache: Tensor, k_scale, v_scale,
                 layer: int, head_major: bool = False):
    """Check the stacked cache (and its scales) the kernels read; returns
    the cache shape and the scale pointers (None for a bf16 cache)."""
    if not kernels_take(k_cache, k_scale):
        raise ValueError(
            "the CUDA ring-decode kernels take a bf16 CUDA cache, or an int8 "
            f"one with its scales, [L, B, M, H <= {K1_MAX_HEADS}, "
            f"{KERNEL_HEAD_DIM}]; got {k_cache.dtype} {tuple(k_cache.shape)} "
            f"on {k_cache.device}")
    dev = k_cache.device
    check_operand("k_cache", k_cache, k_cache.shape, k_cache.dtype, dev)
    check_operand("v_cache", v_cache, k_cache.shape, k_cache.dtype, dev)
    L, B, M, H, _ = k_cache.shape
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    ptrs = (None, None)
    if k_cache.dtype == torch.int8:
        sshape = (L, B, H, M) if head_major else (L, B, M, H)
        check_operand("k_scale", k_scale, sshape, torch.float32, dev)
        check_operand("v_scale", v_scale, sshape, torch.float32, dev)
        ptrs = (k_scale.data_ptr(), v_scale.data_ptr())
    elif k_scale is not None or v_scale is not None:
        raise ValueError("dequant scales come only with an int8 cache")
    return k_cache.shape, ptrs


def _raise_on(rc: int, what: str) -> None:
    if rc:
        msg = _lib().bdm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _stream(dev: torch.device):
    return dev.index or 0, torch.cuda.current_stream(dev).cuda_stream


def _bf16_scale(scale: float) -> float:
    return float(torch.tensor(scale, dtype=torch.bfloat16))


def flash_ring_decode(k_cache: Tensor, v_cache: Tensor, qw: Tensor,
                      bias: Tensor, layer: int,
                      k_scale: Optional[Tensor] = None,
                      v_scale: Optional[Tensor] = None, *, scale: float
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """K1 (bf16 cache) / K6 (int8 cache with scales [L, B, M, H]):
    attention of one query per (row, head) over layer ``layer`` of the
    stacked ring cache. qw [B, H, Dh] (q + r_w_bias, compute dtype), bias
    [B, H, M] f32 -> (o [B, H, Dh], m [B, H, 1], l [B, H, 1]) f32, in one
    launch. The kernel reads the full stacked cache at the layer's
    offset."""
    if k_cache.device.type == "cpu":
        return flash_ring_decode_plain(k_cache, v_cache, qw, bias, layer,
                                       k_scale, v_scale, scale=scale)
    (L, B, M, H, Dh), (ks, vs) = _check_cache(k_cache, v_cache, k_scale,
                                              v_scale, layer)
    dev = k_cache.device
    check_operand("qw", qw, (B, H, Dh), torch.bfloat16, dev)
    check_operand("bias", bias, (B, H, M), torch.float32, dev)
    f32 = dict(device=dev, dtype=torch.float32)
    o = torch.empty(B, H, Dh, **f32)
    m = torch.empty(B, H, 1, **f32)
    l = torch.empty(B, H, 1, **f32)
    # no split scratch: the kernel merges its splits in shared memory
    rc = _lib().bdm_flash_ring_decode(
        k_cache.data_ptr(), v_cache.data_ptr(), ks, vs, qw.data_ptr(),
        bias.data_ptr(), None, None, None, o.data_ptr(), m.data_ptr(),
        l.data_ptr(), layer, B, M, H, _bf16_scale(scale), *_stream(dev))
    name = "flash_ring_decode" + (
        "_int8" if k_cache.dtype == torch.int8 else "")
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return o, m, l


def _prime_launch(name: str, k_cache, v_cache, qw, bias, layer, k_scale,
                  v_scale, scale: float, head_major: bool):
    (L, B, M, H, Dh), (ks, vs) = _check_cache(
        k_cache, v_cache, k_scale, v_scale, layer, head_major)
    dev = k_cache.device
    Q = qw.shape[2] if qw.dim() == 4 else -1
    if not 1 <= Q <= MAX_PRIME_Q:
        raise ValueError(f"qw must be [B, H, Q <= {MAX_PRIME_Q}, Dh], "
                         f"got {tuple(qw.shape)}")
    check_operand("qw", qw, (B, H, Q, Dh), torch.bfloat16, dev)
    check_operand("bias", bias, (B, H, Q, M), torch.float32, dev)
    f32 = dict(device=dev, dtype=torch.float32)
    o = torch.empty(B, H, Q, Dh, **f32)
    m = torch.empty(B, H, Q, **f32)
    l = torch.empty(B, H, Q, **f32)
    # no split scratch: the kernel merges its splits in registers; the
    # scales' stride along M is H for [L, B, M, H], 1 for [L, B, H, M]
    rc = _lib().bdm_flash_ring_prime(
        k_cache.data_ptr(), v_cache.data_ptr(), ks, vs, qw.data_ptr(),
        bias.data_ptr(), None, None, None, o.data_ptr(), m.data_ptr(),
        l.data_ptr(), layer, B, M, H, Q, 1 if head_major else H,
        _bf16_scale(scale), *_stream(dev))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return o, m, l


def flash_ring_prime_ap(k_cache: Tensor, v_cache: Tensor, qw: Tensor,
                        bias: Tensor, layer: int,
                        k_scale: Optional[Tensor] = None,
                        v_scale: Optional[Tensor] = None, *, scale: float
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """K2 (bf16 cache) / K7 (int8 cache, scales [L, B, M, H]):
    :func:`flash_ring_decode` for 2 <= Q <= 32 query rows (the observation
    prime). qw [B, H, Q, Dh], bias [B, H, Q, M] f32 -> (o [B, H, Q, Dh],
    m [B, H, Q], l [B, H, Q]) f32. It serves both values of
    ``decode_prime_compact``: the TPU kernel's two variants compute the
    same function."""
    if k_cache.device.type == "cpu":
        return flash_ring_prime_ap_plain(k_cache, v_cache, qw, bias, layer,
                                         k_scale, v_scale, scale=scale)
    name = "flash_ring_prime_ap" + (
        "_int8" if k_cache.dtype == torch.int8 else "")
    return _prime_launch(name, k_cache, v_cache, qw, bias, layer, k_scale,
                         v_scale, scale, head_major=False)


def flash_ring_prime(k_cache: Tensor, v_cache: Tensor, qw: Tensor,
                     bias: Tensor, layer: int,
                     k_scale_t: Optional[Tensor] = None,
                     v_scale_t: Optional[Tensor] = None, *, scale: float
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """K8, the per-head prime: :func:`flash_ring_prime_ap`'s contract with
    the int8 dequant scales pre-transposed head-major, [L, B, H, M]. The
    decode path does not call it (the JAX package keeps it as K2's oracle);
    the same kernel as K7 reads the scales through their M stride."""
    if k_cache.device.type == "cpu":
        return flash_ring_prime_plain(k_cache, v_cache, qw, bias, layer,
                                      k_scale_t, v_scale_t, scale=scale)
    return _prime_launch("flash_ring_prime", k_cache, v_cache, qw, bias,
                         layer, k_scale_t, v_scale_t, scale, head_major=True)


# ---- online-softmax merges (plain torch, as the JAX package's are XLA) ----

def combine_new_columns(o_unnorm: Tensor, m: Tensor, l: Tensor,
                        s_new: Tensor, v_x: Tensor,
                        compute_dtype=torch.bfloat16) -> Tensor:
    """Merge the new tokens' Q x Q causal block (s_new [B, H, Q, Q] scaled
    scores, NEG_INF where masked; v_x [B, Q, H, Dh]) into the cache-column
    partials. Returns [B, Q, H, Dh] f32."""
    m_t = torch.maximum(m, s_new.amax(-1))                   # [B, H, Q]
    w_c = torch.exp(m - m_t)
    p_new = torch.exp(s_new - m_t[..., None])
    pv = torch.einsum("bhij,bjhd->bhid", p_new.to(compute_dtype),
                      v_x.to(compute_dtype)).float()
    num = o_unnorm * w_c[..., None] + pv
    den = l * w_c + p_new.sum(-1)
    return (num / den[..., None]).permute(0, 2, 1, 3)


def combine_self_column(o_unnorm: Tensor, m: Tensor, l: Tensor, s_x: Tensor,
                        v_x: Tensor) -> Tensor:
    """Two-term merge of the distance-0 self column (s_x [B, H] scaled
    score, v_x [B, H, Dh]). Returns [B, H, Dh] f32."""
    m = m[..., 0]
    l = l[..., 0]
    m_t = torch.maximum(m, s_x)
    a_cache = torch.exp(m - m_t)[..., None]
    a_self = torch.exp(s_x - m_t)[..., None]
    num = o_unnorm * a_cache + a_self * v_x.float()
    den = l[..., None] * a_cache + a_self
    return num / den
