"""TransformerXL relative attention over a full sequence: the CUDA kernel K3
(forward), its plain PyTorch version and the gate that picks it.

Counterpart of bdm_db1_tpu/ops/pallas_attention.py (the forward of
``pallas_rel_attention`` / ``pallas_rel_attention_anylen``). For q
[B, qlen, H, Dh], k/v [B, klen, H, Dh], rk [klen, H, Dh] and the biases
[H, Dh]:

    AC[i, j] = (q_i + r_w) . k_j,   BD[i, j] = (q_i + r_r) . rk[j - i + qlen - 1]
    s = (AC + BD) * scale, NEG_INF where banned (causal with a memory
        prefix; with ``same_length`` also the sliding window)
    m = max_j s, l = sum_j exp(s - m), out = (cdt(exp(s - m)) @ v) / max(l, 1e-30)

with ``cdt`` the value dtype and ``out`` in q's dtype. The kernel walks key
tiles with an online softmax (csrc/flash_rel_attention.cu); the plain
version takes the full f32 score matrix. Both return the row stats (m, l)
[B, H, qlen] in f32 beside the output, which the backward kernels (K4/K5,
the training slice) will read.

The wrapper takes a tensor's device as the route: CPU tensors run the plain
version, CUDA tensors launch the kernel (built on first use) or raise. The
kernel takes bf16 q/k/v/rk with a head dim of 128, heads packed and
16-byte aligned rows; it reads q, k and v through their batch and token
strides (slices of the fused QKV projection need no copy). No gradient
passes through either route yet: with grad mode on, an input that requires
grad raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from bdm_db1_tpu_torch.ops.attention import (
    causal_mask, rel_shift_sliced, same_length_mask,
)
from bdm_db1_tpu_torch.ops.cuda_build import check_operand, load_library

NEG_INF = -1e30
# the JAX gate's block size: it decides which shapes take the kernel route
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
# what csrc/flash_rel_attention.cu takes (checked against the library)
KERNEL_HEAD_DIM = 128
KERNEL_BLOCK_Q = 64
KERNEL_BLOCK_K = 64

LAUNCHES = {"flash_rel_attention": 0}

Tensor = torch.Tensor


# ---- the gate (the JAX package's applicability tests, copied) ------------

def pallas_applicable(qlen: int, klen: int, block_q: int = DEFAULT_BLOCK_Q,
                      block_k: int = DEFAULT_BLOCK_K) -> bool:
    """Block-aligned shapes that the JAX kernel takes unpadded."""
    bq, bk = min(block_q, qlen), min(block_k, klen)
    return (qlen % bq == 0 and klen % bk == 0 and klen >= bq + bk
            and qlen >= 8 and klen >= 128)


def pallas_anylen_applicable(qlen: int, klen: int,
                             block: int = DEFAULT_BLOCK_Q) -> bool:
    """Shapes that the JAX padding wrapper takes: any qlen >= 64 over a
    block-aligned memory prefix."""
    mlen = klen - qlen
    d = (-qlen) % block
    return mlen % block == 0 and qlen >= 64 and (klen + d) >= 2 * block


def kernel_route_applicable(qlen: int, klen: int) -> bool:
    """Whether the kernel route serves (qlen, klen): the JAX package's
    ``_use_pallas`` shape test, so both packages route the same calls."""
    return pallas_applicable(qlen, klen) or pallas_anylen_applicable(qlen, klen)


# ---- plain version ---------------------------------------------------------

def flash_rel_attention_plain(q: Tensor, k: Tensor, v: Tensor, rk: Tensor,
                              r_w_bias: Tensor, r_r_bias: Tensor, *,
                              mem_len: int, same_length: bool, scale: float
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain K3: full f32 scores, the kernel's mask, p rounded to v's dtype
    before an f32-accumulated PV product. Returns (out [B, qlen, H, Dh] in
    q's dtype, m, l [B, H, qlen] f32)."""
    qlen, klen = q.shape[1], k.shape[1]
    qf = q.float()
    ac = torch.einsum("bihd,bjhd->bhij", qf + r_w_bias.float(), k.float())
    # column t of the raw product is rk row t; BD[i, j] = raw[i, j + qlen-1-i]
    bd = rel_shift_sliced(torch.einsum("bihd,jhd->bhij",
                                       qf + r_r_bias.float(), rk.float()))
    scores = (ac + bd) * scale
    banned = (same_length_mask(qlen, klen, mem_len, device=q.device)
              if same_length else causal_mask(qlen, klen, device=q.device))
    scores = torch.where(banned, NEG_INF, scores)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhij,bjhd->bihd", p.to(v.dtype).float(), v.float())
    out = acc / l.clamp(min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype), m, l


# ---- kernel ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("flash_rel_attention")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bdm_flash_rel_attention.argtypes = (
        [P] * 11 + [LL] * 6 + [I] * 6 + [ctypes.c_float, I, P])
    lib.bdm_flash_rel_attention.restype = I
    lib.bdm_rel_error_string.argtypes = [I]
    lib.bdm_rel_error_string.restype = ctypes.c_char_p
    for fn, want in (("bdm_rel_head_dim", KERNEL_HEAD_DIM),
                     ("bdm_rel_block_q", KERNEL_BLOCK_Q),
                     ("bdm_rel_block_k", KERNEL_BLOCK_K)):
        getattr(lib, fn).restype = I
        got = getattr(lib, fn)()
        if got != want:
            raise RuntimeError(f"{fn}() = {got}, the wrapper expects {want}")
    return lib


def _check_strided(name: str, t: Tensor, shape, device) -> None:
    """A [B, T, H, Dh] bf16 operand read through its batch and token
    strides: heads packed, 16-byte aligned rows."""
    if t.device != device or t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bf16 on {device}, got {t.dtype} on "
                        f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    sb, st, sh, sd = t.stride()
    if (sd != 1 or sh != KERNEL_HEAD_DIM or sb % 8 or st % 8
            or t.data_ptr() % 16):
        raise ValueError(f"{name} needs packed heads and 16-byte aligned "
                         f"rows, got strides {t.stride()}")


def _launch(q, k, v, rk, r_w_bias, r_r_bias, mem_len, same_length, scale):
    dev = q.device
    B, qlen, H, Dh = q.shape
    klen = k.shape[1]
    if Dh != KERNEL_HEAD_DIM or klen < qlen:
        raise ValueError(f"the K3 kernel takes Dh = {KERNEL_HEAD_DIM} and "
                         f"klen >= qlen, got q {tuple(q.shape)}, klen {klen}")
    _check_strided("q", q, (B, qlen, H, Dh), dev)
    _check_strided("k", k, (B, klen, H, Dh), dev)
    _check_strided("v", v, (B, klen, H, Dh), dev)
    check_operand("rk", rk, (klen, H, Dh), torch.bfloat16, dev)
    rw = r_w_bias.float().contiguous()
    rr = r_r_bias.float().contiguous()
    check_operand("r_w_bias", rw, (H, Dh), torch.float32, dev)
    check_operand("r_r_bias", rr, (H, Dh), torch.float32, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty(B, qlen, H, Dh, dtype=torch.bfloat16, device=dev)
    m = torch.empty(B, H, qlen, **f32)
    l = torch.empty(B, H, qlen, **f32)
    # scratch: the per-key f32 terms r_w . k_j and r_r . rk_t
    rwk = torch.empty(B * H * klen, **f32)
    rrk = torch.empty(H * klen, **f32)
    rc = _lib().bdm_flash_rel_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rk.data_ptr(),
        rw.data_ptr(), rr.data_ptr(), out.data_ptr(), m.data_ptr(),
        l.data_ptr(), rwk.data_ptr(), rrk.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), B, H, qlen, klen, mem_len,
        int(same_length), scale, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        msg = _lib().bdm_rel_error_string(rc).decode()
        raise RuntimeError(f"flash_rel_attention launch failed: {msg} ({rc})")
    LAUNCHES["flash_rel_attention"] += 1
    return out, m, l


def flash_rel_attention(q: Tensor, k: Tensor, v: Tensor, rk: Tensor,
                        r_w_bias: Tensor, r_r_bias: Tensor, *, mem_len: int,
                        same_length: bool, scale: float,
                        with_stats: bool = False
                        ) -> Union[Tensor, Tuple[Tensor, Tuple[Tensor, Tensor]]]:
    """K3: relative attention of q [B, qlen, H, Dh] over k/v [B, klen, H,
    Dh] (klen - qlen memory rows first), rk [klen, H, Dh], biases [H, Dh]
    -> out [B, qlen, H, Dh] in q's dtype, and (m, l) [B, H, qlen] f32 with
    ``with_stats``. Any qlen and klen >= qlen: the ragged edges are masked
    in place of the JAX wrapper's padding."""
    ins = (q, k, v, rk, r_w_bias, r_r_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise RuntimeError(
            "flash_rel_attention has no backward yet: call it under "
            "torch.no_grad() or torch.inference_mode()")
    kw = dict(mem_len=mem_len, same_length=same_length, scale=scale)
    if q.device.type == "cpu":
        out, m, l = flash_rel_attention_plain(*ins, **kw)
    else:
        out, m, l = _launch(*ins, mem_len, same_length, scale)
    return (out, (m, l)) if with_stats else out
