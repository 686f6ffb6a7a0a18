"""TransformerXL relative attention over a full sequence: the CUDA kernels K3
(forward), K4 and K5 (backward), their plain PyTorch versions, the
dispatcher op around them (``bdm::flash_rel_attention``, a
``torch.library.custom_op`` whose autograd runs K4 and K5, so that a remat
policy can keep K3's outputs) and the gate that picks the route.

Counterpart of bdm_db1_tpu/ops/pallas_attention.py (``pallas_rel_attention``
with its custom VJP, and ``pallas_rel_attention_anylen``). For q
[B, qlen, H, Dh], k/v [B, klen, H, Dh], rk [klen, H, Dh] and the biases
[H, Dh]:

    AC[i, j] = (q_i + r_w) . k_j,   BD[i, j] = (q_i + r_r) . rk[j - i + qlen - 1]
    s = (AC + BD) * scale, NEG_INF where banned (causal with a memory
        prefix; with ``same_length`` also the sliding window)
    m = max_j s, l = sum_j exp(s - m), out = (cdt(exp(s - m)) @ v) / max(l, 1e-30)

with ``cdt`` the value dtype and ``out`` in q's dtype. The kernel walks key
tiles with an online softmax (csrc/flash_rel_attention.cu); the plain
version takes the full f32 score matrix. Both return the row stats (m, l)
[B, H, qlen] in f32 beside the output.

The backward (csrc/flash_rel_attention_bwd.cu) recomputes p = exp(s - m) / l
from those stats: a preparation kernel makes delta = rowsum(dO * O) and the
per-key terms once, then K4 makes dq, K5 dk, dv, drk (summed over the
batch) and the bias gradients drw, drr. Their plain version recomputes the
full f32 score matrix from (m, l) and follows the same contract; it is
written out, never autograd through the plain forward.

The wrappers take a tensor's device as the route: CPU tensors run the plain
versions, CUDA tensors launch the kernels (built on first use) or raise.
The kernels take bf16 q/k/v/rk with a head dim of 128, heads packed and
16-byte aligned rows; they read q, k and v through their batch and token
strides (slices of the fused QKV projection need no copy). ``LAUNCHES``
counts kernel launches.
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
# what csrc/flash_rel_attention.cu (K3) and csrc/flash_rel_attention_bwd.cu
# (K4, K5) take (checked against the libraries): query rows a block, keys a
# tile
KERNEL_HEAD_DIM = 128
K3_BLOCK_Q = 128
KERNEL_BLOCK_Q = 64
KERNEL_BLOCK_K = 64

LAUNCHES = {"flash_rel_attention": 0, "flash_rel_attention_bwd_dq": 0,
            "flash_rel_attention_bwd_dkv": 0}

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


# ---- plain versions --------------------------------------------------------

def _wide(t: Tensor) -> Tensor:
    """f32, or the wider dtype a caller gave (f64 for gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _banned(qlen: int, klen: int, mem_len: int, same_length: bool, device):
    return (same_length_mask(qlen, klen, mem_len, device=device)
            if same_length else causal_mask(qlen, klen, device=device))


def _plain_scores(q, k, rk, r_w_bias, r_r_bias, mem_len, same_length, scale):
    """The kernels' full score matrix [B, H, qlen, klen] in f32 (or wider),
    banned entries at NEG_INF, and (q + r_r) for the BD gradients."""
    qlen, klen = q.shape[1], k.shape[1]
    qf = _wide(q)
    qr = qf + _wide(r_r_bias)
    ac = torch.einsum("bihd,bjhd->bhij", qf + _wide(r_w_bias), _wide(k))
    # column t of the raw product is rk row t; BD[i, j] = raw[i, j + qlen-1-i]
    bd = rel_shift_sliced(torch.einsum("bihd,jhd->bhij", qr, _wide(rk)))
    scores = (ac + bd) * scale
    banned = _banned(qlen, klen, mem_len, same_length, q.device)
    return torch.where(banned, NEG_INF, scores), qr


def flash_rel_attention_plain(q: Tensor, k: Tensor, v: Tensor, rk: Tensor,
                              r_w_bias: Tensor, r_r_bias: Tensor, *,
                              mem_len: int, same_length: bool, scale: float
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain K3: full f32 scores, the kernel's mask, p rounded to v's dtype
    before an f32-accumulated PV product. Returns (out [B, qlen, H, Dh] in
    q's dtype, m, l [B, H, qlen] f32)."""
    scores, _ = _plain_scores(q, k, rk, r_w_bias, r_r_bias, mem_len,
                              same_length, scale)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhij,bjhd->bihd", _wide(p.to(v.dtype)), _wide(v))
    out = acc / l.clamp(min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype), m, l


def _unshift(ds: Tensor) -> Tensor:
    """The gradient of :func:`rel_shift_sliced` (the transpose of its
    strided view): dS [B, H, q, k] -> d_raw [B, H, q, k] with
    d_raw[i, j + q-1-i] = dS[i, j]; entries that land past column k held
    the forward's zero padding and are dropped."""
    b, h, q, k = ds.shape
    if q == 1:
        return ds
    xp = ds.new_zeros(b, h, q, k + q - 1)
    s0, s1 = xp.stride(0), xp.stride(1)
    xp.as_strided((b, h, q, k), (s0, s1, k + q - 2, 1), q - 1).copy_(ds)
    return xp[..., :k]


def bwd_delta_plain(out: Tensor, dout: Tensor) -> Tensor:
    """delta = rowsum(dO * O) [B, H, qlen] in f32 (or wider), as the JAX
    package computes it once per backward (XLA) and the CUDA route's
    preparation kernel does."""
    return (_wide(dout) * _wide(out)).sum(-1).transpose(1, 2)


def flash_rel_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, rk: Tensor,
                                  r_w_bias: Tensor, r_r_bias: Tensor,
                                  out: Tensor, m: Tensor, l: Tensor,
                                  dout: Tensor, *, mem_len: int,
                                  same_length: bool, scale: float
                                  ) -> Tuple[Tensor, ...]:
    """Plain K4 + K5: the six gradients (dq, dk, dv, drk, drw, drr) of
    ``_pallas_rel_attention_bwd_impl``, each in its input's dtype, from the
    forward's output and row stats. p = exp(s - m) / max(l, 1e-30) from
    the recomputed f32 scores; delta = rowsum(dO * O); dS = p (dP - delta)
    scale; the BD gradients go through the rel-shift's transpose; drk is
    summed over the batch."""
    scores, qr = _plain_scores(q, k, rk, r_w_bias, r_r_bias, mem_len,
                               same_length, scale)
    p = torch.exp(scores - m[..., None]) / l.clamp(min=1e-30)[..., None]
    do = _wide(dout)
    delta = bwd_delta_plain(out, dout)                         # [B, H, q]
    dp = torch.einsum("bihd,bjhd->bhij", do, _wide(v))
    ds = p * (dp - delta[..., None]) * scale
    draw = _unshift(ds)
    kf = _wide(k)
    dq_ac = torch.einsum("bhij,bjhd->bihd", ds, kf)
    dq_bd = torch.einsum("bhij,jhd->bihd", draw, _wide(rk))
    dk = torch.einsum("bhij,bihd->bjhd", ds, _wide(q) + _wide(r_w_bias))
    dv = torch.einsum("bhij,bihd->bjhd", p, do)
    drk = torch.einsum("bhij,bihd->jhd", draw, qr)
    return ((dq_ac + dq_bd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            drk.to(rk.dtype), dq_ac.sum((0, 1)).to(r_w_bias.dtype),
            dq_bd.sum((0, 1)).to(r_r_bias.dtype))


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
                     ("bdm_rel_block_q", K3_BLOCK_Q),
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


@functools.lru_cache(maxsize=None)
def _lib_bwd() -> ctypes.CDLL:
    lib = load_library("flash_rel_attention_bwd")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bdm_rel_bwd.argtypes = (
        [I] + [P] * 19 + [LL] * 6 + [I] * 6 + [ctypes.c_float, I, P])
    lib.bdm_rel_bwd.restype = I
    lib.bdm_rel_bwd_error_string.argtypes = [I]
    lib.bdm_rel_bwd_error_string.restype = ctypes.c_char_p
    for fn, want in (("bdm_rel_bwd_head_dim", KERNEL_HEAD_DIM),
                     ("bdm_rel_bwd_block_q", KERNEL_BLOCK_Q),
                     ("bdm_rel_bwd_block_k", KERNEL_BLOCK_K)):
        getattr(lib, fn).restype = I
        got = getattr(lib, fn)()
        if got != want:
            raise RuntimeError(f"{fn}() = {got}, the wrapper expects {want}")
    return lib


# the C entry's pointer arguments, in order
_BWD_PTRS = ("q", "k", "v", "rk", "rw", "rr", "dout", "out", "m", "l", "delta",
             "rwk", "rrk", "dq", "dk", "dv", "drk", "drw", "drr")
_BWD_STEPS = {"prep": 0, "dq": 1, "dkv": 2}


def _bwd_operands(q, k, v, rk, r_w_bias, r_r_bias, out, m, l, dout):
    """The checked operands of one CUDA backward, its scratch (delta, the
    key terms) and its outputs, by the C entry's names."""
    dev = q.device
    B, qlen, H, Dh = q.shape
    klen = k.shape[1]
    if Dh != KERNEL_HEAD_DIM or klen < qlen:
        raise ValueError(f"the K4/K5 kernels take Dh = {KERNEL_HEAD_DIM} and "
                         f"klen >= qlen, got q {tuple(q.shape)}, klen {klen}")
    _check_strided("q", q, (B, qlen, H, Dh), dev)
    _check_strided("k", k, (B, klen, H, Dh), dev)
    _check_strided("v", v, (B, klen, H, Dh), dev)
    check_operand("rk", rk, (klen, H, Dh), torch.bfloat16, dev)
    t = dict(q=q, k=k, v=v, rk=rk, dout=dout.contiguous(),
             out=out.contiguous(), m=m, l=l,
             rw=r_w_bias.float().contiguous(), rr=r_r_bias.float().contiguous())
    for name in ("dout", "out"):
        check_operand(name, t[name], (B, qlen, H, Dh), torch.bfloat16, dev)
    for name in ("rw", "rr"):
        check_operand(name, t[name], (H, Dh), torch.float32, dev)
    for name in ("m", "l"):
        check_operand(name, t[name], (B, H, qlen), torch.float32, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    # one f32 scratch for rwk [B, H, klen], rrk [H, klen], delta [B, H, qlen]
    scratch = torch.empty(B * H * klen + H * klen + B * H * qlen, **f32)
    t["rwk"], t["rrk"], t["delta"] = scratch.split(
        (B * H * klen, H * klen, B * H * qlen))
    t["delta"] = t["delta"].view(B, H, qlen)
    t["dq"] = torch.empty(B, qlen, H, Dh, dtype=torch.bfloat16, device=dev)
    t["dk"] = torch.empty(B, klen, H, Dh, dtype=torch.bfloat16, device=dev)
    t["dv"] = torch.empty_like(t["dk"])
    # the sums K5 adds into, zeroed at once: drk [klen, H, Dh], drw, drr
    sums = torch.zeros(klen * H * Dh + 2 * H * Dh, **f32)
    drk, drw, drr = sums.split((klen * H * Dh, H * Dh, H * Dh))
    t["drk"] = drk.view(klen, H, Dh)
    t["drw"], t["drr"] = drw.view(H, Dh), drr.view(H, Dh)
    return t


def _bwd_step(step: str, t: dict, mem_len: int, same_length: bool,
              scale: float) -> None:
    """One launch of the backward on the operands of :func:`_bwd_operands`:
    ``step`` "prep" (delta and the key terms; without ``t["out"]`` the key
    terms alone), "dq" (K4) or "dkv" (K5)."""
    q, k, v = t["q"], t["k"], t["v"]
    dev = q.device
    B, qlen, H, _ = q.shape
    lib = _lib_bwd()
    ptrs = [0 if t.get(n) is None else t[n].data_ptr() for n in _BWD_PTRS]
    rc = lib.bdm_rel_bwd(
        _BWD_STEPS[step], *ptrs, q.stride(0), q.stride(1), k.stride(0),
        k.stride(1), v.stride(0), v.stride(1), B, H, qlen, k.shape[1],
        mem_len, int(same_length), scale, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        msg = lib.bdm_rel_bwd_error_string(rc).decode()
        raise RuntimeError(f"flash_rel_attention backward ({step}) launch "
                           f"failed: {msg} ({rc})")
    if step != "prep":
        LAUNCHES["flash_rel_attention_bwd_" + step] += 1


def flash_rel_attention_bwd(q: Tensor, k: Tensor, v: Tensor, rk: Tensor,
                            r_w_bias: Tensor, r_r_bias: Tensor, out: Tensor,
                            m: Tensor, l: Tensor, dout: Tensor, *,
                            mem_len: int, same_length: bool, scale: float
                            ) -> Tuple[Tensor, ...]:
    """K4 + K5: (dq, dk, dv, drk, drw, drr) of the relative attention whose
    forward gave ``out`` and (m, l), for the upstream gradient ``dout``,
    each in its input's dtype (drk summed over the batch in f32, then
    cast). CPU tensors take the plain version; CUDA tensors three launches:
    the preparation (delta and the key terms, once for both kernels), K4,
    K5."""
    args = (q, k, v, rk, r_w_bias, r_r_bias, out, m, l, dout)
    if q.device.type == "cpu":
        return flash_rel_attention_bwd_plain(
            *args, mem_len=mem_len, same_length=same_length, scale=scale)
    t = _bwd_operands(*args)
    for step in ("prep", "dq", "dkv"):
        _bwd_step(step, t, mem_len, same_length, scale)
    return (t["dq"], t["dk"], t["dv"], t["drk"].to(rk.dtype),
            t["drw"].to(r_w_bias.dtype), t["drr"].to(r_r_bias.dtype))


@torch.library.custom_op("bdm::flash_rel_attention", mutates_args=())
def _k3(q: Tensor, k: Tensor, v: Tensor, rk: Tensor, r_w_bias: Tensor,
        r_r_bias: Tensor, mem_len: int, same_length: bool, scale: float
        ) -> Tuple[Tensor, Tensor, Tensor]:
    """K3 (its plain version on CPU tensors) as a dispatcher op, so that a
    selective-checkpoint policy can name and keep its outputs (the JAX
    package names them ``pallas_attn_out/m/l``)."""
    ins = (q, k, v, rk, r_w_bias, r_r_bias)
    if q.device.type == "cpu":
        return flash_rel_attention_plain(
            *ins, mem_len=mem_len, same_length=same_length, scale=scale)
    return _launch(*ins, mem_len, same_length, scale)


def _k3_setup(ctx, inputs, output):
    """The custom VJP's residuals, as ``_fwd`` of ``pallas_rel_attention``
    keeps them: q, k, v, rk, the biases, out, m and l. (m, l) are outputs
    without a gradient."""
    *ins, mem_len, same_length, scale = inputs
    out, m, l = output
    ctx.save_for_backward(*ins, out, m, l)
    ctx.kw = dict(mem_len=mem_len, same_length=same_length, scale=scale)
    ctx.mark_non_differentiable(m, l)


def _k3_backward(ctx, dout, _dm, _dl):
    """K4 + K5: the six gradients (``_bwd``)."""
    grads = flash_rel_attention_bwd(*ctx.saved_tensors, dout, **ctx.kw)
    return grads + (None, None, None)


_k3.register_autograd(_k3_backward, setup_context=_k3_setup)
# the op a remat policy matches (models/transformer_xl.py remat_policy)
K3_OP = torch.ops.bdm.flash_rel_attention.default


def flash_rel_attention(q: Tensor, k: Tensor, v: Tensor, rk: Tensor,
                        r_w_bias: Tensor, r_r_bias: Tensor, *, mem_len: int,
                        same_length: bool, scale: float,
                        with_stats: bool = False
                        ) -> Union[Tensor, Tuple[Tensor, Tuple[Tensor, Tensor]]]:
    """K3: relative attention of q [B, qlen, H, Dh] over k/v [B, klen, H,
    Dh] (klen - qlen memory rows first), rk [klen, H, Dh], biases [H, Dh]
    -> out [B, qlen, H, Dh] in q's dtype, and (m, l) [B, H, qlen] f32 with
    ``with_stats``. Any qlen and klen >= qlen: the ragged edges are masked
    in place of the JAX wrapper's padding. Gradients flow to all six inputs
    through K4 and K5 (their plain versions on the CPU)."""
    out, m, l = _k3(q, k, v, rk, r_w_bias, r_r_bias, mem_len, same_length,
                    float(scale))
    return (out, (m, l)) if with_stats else out


