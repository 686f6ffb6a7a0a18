"""Ring-cache decode attention: the CUDA kernels K1 (q == 1) and K2
(2 <= Q <= 32), their plain PyTorch versions, and the online-softmax merges.

Counterpart of bdm_db1_tpu/ops/flash_ring_decode.py. Each kernel computes
what the Pallas kernel's wrapper returns, for one layer of the stacked ring
cache ``[L, B, M, H, Dh]``:

    s = bf16(qw * bf16(scale)) . k + bias      (bias: scaled BD term in ring
                                                order, NEG_INF at banned slots)
    per key block: m_blk = max s, p = exp(s - m_blk), l_blk = sum p,
                   o_blk = sum bf16(p) * v
    merged: m = max m_blk, w = exp(m_blk - m), o = sum w o_blk, l = sum w l_blk

and returns the UNNORMALISED ``o`` with ``(m, l)``; :func:`combine_self_column`
and :func:`combine_new_columns` fold in the new tokens' own columns.

``NEG_INF`` is -1e30, not -inf: a block whose slots are all banned gets
``m_blk = -1e30`` and junk ``(o, l)``, and only its merge weight
``exp(-1e30 - m) = 0`` removes it (with -inf the merge would give NaN).

The wrappers take a tensor's device as the route: CPU tensors run the plain
version, CUDA tensors launch the kernel (csrc/flash_ring_decode.cu, built on
first use) or raise. The kernels take bf16 caches with a head dim of 128;
the plain versions take any floating dtype and shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from bdm_db1_tpu_torch.ops.cuda_build import load_library

NEG_INF = -1e30
DEFAULT_BLOCK_M = 512
MAX_PRIME_Q = 32
# what csrc/flash_ring_decode.cu takes (checked against the library on load)
KERNEL_HEAD_DIM = 128
K1_MAX_HEADS = 32
K1_SPLIT = 64          # keys per K1 block: its softmax block size
K2_SPLIT = 128         # keys per K2 block

Tensor = torch.Tensor


# ---- plain versions -------------------------------------------------------

def _scaled(qw: Tensor, scale: float) -> Tensor:
    """Fold 1/sqrt(Dh) into the query in its own dtype, as the kernels do."""
    return qw * torch.tensor(scale, dtype=qw.dtype)


def _attend_blocks(qs: Tensor, k: Tensor, v: Tensor, bias: Tensor,
                   block_m: int) -> Tuple[Tensor, Tensor, Tensor]:
    """qs [B, H, Q, Dh] scaled queries, k/v [B, M, H, Dh] one layer, bias
    [B, H, Q, M] f32 -> blockwise partials o [B, nm, H, Q, Dh],
    m/l [B, nm, H, Q], then merged. A ragged last block is padded with keys
    of score -inf, which get probability 0."""
    B, M, H, Dh = k.shape
    Q = qs.shape[2]
    bm = min(block_m, M)
    nm = -(-M // bm)
    pad = nm * bm - M
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        bias = F.pad(bias, (0, pad), value=float("-inf"))
    kb = k.reshape(B, nm, bm, H, Dh).float()
    vb = v.reshape(B, nm, bm, H, Dh)
    bias_b = bias.reshape(B, H, Q, nm, bm).permute(0, 3, 1, 2, 4)
    s = torch.einsum("bhqd,bnmhd->bnhqm", qs.float(), kb) + bias_b
    m_blk = s.amax(-1)                                       # [B, nm, H, Q]
    p = torch.exp(s - m_blk[..., None])
    l_blk = p.sum(-1)
    # p rounds to the cache dtype before the PV product (f32 accumulation)
    o_blk = torch.einsum("bnhqm,bnmhd->bnhqd", p.to(v.dtype).float(),
                         vb.float())
    m_f = m_blk.amax(1)                                      # [B, H, Q]
    w = torch.exp(m_blk - m_f[:, None])
    o_un = torch.einsum("bnhqd,bnhq->bhqd", o_blk, w)
    l_f = (l_blk * w).sum(1)
    return o_un, m_f, l_f


def flash_ring_decode_plain(k_cache: Tensor, v_cache: Tensor, qw: Tensor,
                            bias: Tensor, layer: int, *, scale: float,
                            block_m: int = DEFAULT_BLOCK_M
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain K1: qw [B, H, Dh], bias [B, H, M] -> (o [B, H, Dh],
    m [B, H, 1], l [B, H, 1]), all f32."""
    o, m, l = _attend_blocks(_scaled(qw, scale)[:, :, None], k_cache[layer],
                             v_cache[layer], bias[:, :, None], block_m)
    return o[:, :, 0], m, l


def flash_ring_prime_plain(k_cache: Tensor, v_cache: Tensor, qw: Tensor,
                           bias: Tensor, layer: int, *, scale: float,
                           block_m: int = DEFAULT_BLOCK_M
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain K2: qw [B, H, Q, Dh], bias [B, H, Q, M] -> (o [B, H, Q, Dh],
    m [B, H, Q], l [B, H, Q]), all f32."""
    return _attend_blocks(_scaled(qw, scale), k_cache[layer], v_cache[layer],
                          bias, block_m)


# ---- kernels --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("flash_ring_decode")
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bdm_flash_ring_decode.argtypes = [P] * 10 + [I] * 4 + [Fl, I, P]
    lib.bdm_flash_ring_decode.restype = I
    lib.bdm_flash_ring_prime.argtypes = [P] * 10 + [I] * 5 + [Fl, I, P]
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


def kernels_take(k_cache: Tensor) -> bool:
    """Whether the CUDA kernels take this stacked cache."""
    return (k_cache.is_cuda and k_cache.dtype == torch.bfloat16
            and k_cache.dim() == 5 and k_cache.shape[-1] == KERNEL_HEAD_DIM
            and k_cache.shape[-2] <= K1_MAX_HEADS)


def _check(name: str, t: Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the cache on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_cache(k_cache: Tensor, v_cache: Tensor, layer: int):
    if not kernels_take(k_cache):
        raise ValueError(
            "the CUDA ring-decode kernels take a bf16 CUDA cache "
            f"[L, B, M, H <= {K1_MAX_HEADS}, {KERNEL_HEAD_DIM}]; got "
            f"{k_cache.dtype} {tuple(k_cache.shape)} on {k_cache.device}")
    _check("k_cache", k_cache, k_cache.shape, torch.bfloat16, k_cache.device)
    _check("v_cache", v_cache, k_cache.shape, torch.bfloat16, k_cache.device)
    L = k_cache.shape[0]
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    return k_cache.shape


def _raise_on(rc: int, what: str) -> None:
    if rc:
        msg = _lib().bdm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def flash_ring_decode(k_cache: Tensor, v_cache: Tensor, qw: Tensor,
                      bias: Tensor, layer: int, *, scale: float
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """K1: attention of one query per (row, head) over layer ``layer`` of
    the stacked ring cache. qw [B, H, Dh] (q + r_w_bias, compute dtype),
    bias [B, H, M] f32 -> (o [B, H, Dh], m [B, H, 1], l [B, H, 1]) f32.
    The kernel reads the full stacked cache at the layer's offset."""
    if k_cache.device.type == "cpu":
        return flash_ring_decode_plain(k_cache, v_cache, qw, bias, layer,
                                       scale=scale)
    L, B, M, H, Dh = _check_cache(k_cache, v_cache, layer)
    dev = k_cache.device
    _check("qw", qw, (B, H, Dh), torch.bfloat16, dev)
    _check("bias", bias, (B, H, M), torch.float32, dev)
    S = -(-M // K1_SPLIT)
    f32 = dict(device=dev, dtype=torch.float32)
    o_part = torch.empty(B, S, H, Dh, **f32)
    m_part = torch.empty(B, S, H, **f32)
    l_part = torch.empty(B, S, H, **f32)
    o = torch.empty(B, H, Dh, **f32)
    m = torch.empty(B, H, 1, **f32)
    l = torch.empty(B, H, 1, **f32)
    rc = _lib().bdm_flash_ring_decode(
        k_cache.data_ptr(), v_cache.data_ptr(), qw.data_ptr(),
        bias.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
        layer, B, M, H, float(torch.tensor(scale, dtype=torch.bfloat16)),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "flash_ring_decode")
    flash_ring_decode.launches += 1
    return o, m, l


flash_ring_decode.launches = 0


def flash_ring_prime(k_cache: Tensor, v_cache: Tensor, qw: Tensor,
                     bias: Tensor, layer: int, *, scale: float
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """K2: :func:`flash_ring_decode` for 2 <= Q <= 32 query rows (the
    observation prime). qw [B, H, Q, Dh], bias [B, H, Q, M] f32 ->
    (o [B, H, Q, Dh], m [B, H, Q], l [B, H, Q]) f32. It serves both values
    of ``decode_prime_compact``: the TPU kernel's two variants compute the
    same function."""
    if k_cache.device.type == "cpu":
        return flash_ring_prime_plain(k_cache, v_cache, qw, bias, layer,
                                      scale=scale)
    L, B, M, H, Dh = _check_cache(k_cache, v_cache, layer)
    dev = k_cache.device
    Q = qw.shape[2] if qw.dim() == 4 else -1
    if not 1 <= Q <= MAX_PRIME_Q:
        raise ValueError(f"qw must be [B, H, Q <= {MAX_PRIME_Q}, Dh], "
                         f"got {tuple(qw.shape)}")
    _check("qw", qw, (B, H, Q, Dh), torch.bfloat16, dev)
    _check("bias", bias, (B, H, Q, M), torch.float32, dev)
    S = -(-M // K2_SPLIT)
    f32 = dict(device=dev, dtype=torch.float32)
    o_part = torch.empty(B, S, H, Q, Dh, **f32)
    m_part = torch.empty(B, S, H, Q, **f32)
    l_part = torch.empty(B, S, H, Q, **f32)
    o = torch.empty(B, H, Q, Dh, **f32)
    m = torch.empty(B, H, Q, **f32)
    l = torch.empty(B, H, Q, **f32)
    rc = _lib().bdm_flash_ring_prime(
        k_cache.data_ptr(), v_cache.data_ptr(), qw.data_ptr(),
        bias.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
        layer, B, M, H, Q, float(torch.tensor(scale, dtype=torch.bfloat16)),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "flash_ring_prime")
    flash_ring_prime.launches += 1
    return o, m, l


flash_ring_prime.launches = 0


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
