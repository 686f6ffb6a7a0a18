"""int8 trunk weights: per-output-channel quantization, the CUDA kernel K9
(``quant_matmul``, y = x @ dequant(W)^T with the dequant inside the
kernel) with its plain PyTorch version, and the W8A8 product.

Counterpart of bdm_db1_tpu/ops/quant_matmul.py. Weights are in the torch
[N, K] (out, in) layout, so the JAX [K, N] kernel's int8 values and scales
are these transposed. ``quant_matmul`` takes a CPU tensor's route through
its plain version and a CUDA tensor's through csrc/quant_matmul.cu (built at
first use) or raises; ``LAUNCHES`` counts its launches.
``plan_quant_matmul`` chooses the kernel's x-row tile, K split and grid; it
is plain Python, so the CPU tests hold it. ``w8a8_matmul`` is
XLA in the JAX package, not a Pallas kernel: on the card its int8 x int8 ->
int32 product is ``torch._int_mm``, on the CPU an exact integer product.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from bdm_db1_tpu_torch.ops.cuda_build import check_operand, load_library

Tensor = torch.Tensor
KERNEL_K_ALIGN = 32     # K must be a multiple of this (checked on load)

LAUNCHES = {"quant_matmul": 0}
ROW_LAUNCHES: Dict[int, int] = {}   # the same launches by row count R

# the kernel's compiled tiles, (x rows = wgmma n, W rows a CTA): up to 64
# x rows four consumer warpgroups on 64 W rows, each a quarter of the K
# steps; wider, two warpgroups of 64 W rows each
QMM_TILES = ((56, 64), (64, 64), (136, 128), (208, 128), (256, 128))
QMM_WAYS = 4              # K ways within a CTA of the 64-row tiles
QMM_BK = 64               # K elements a pipeline step
QMM_SPLIT_CAP = 8         # most K splits a tile (one cluster of CTAs)
QMM_MIN_WAY_STEPS = 8     # fewest K steps a way keeps when K is split
QMM_SMALL_R = 64          # rows up to which the weight stream bounds K9
H100_SMS = 132


def quantize_weight(w: Tensor, absmax: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tensor]:
    """Symmetric per-output-channel int8 quantization of a [N, K] weight:
    (w_int8 [N, K], scale [N] f32) with w ~= w_int8 * scale[:, None]. A zero
    row gets scale 1.0. ``absmax`` [N]: each row's largest magnitude when
    ``w`` is a slice of the rows (a row-parallel shard: the max over the
    whole row, reduced over the model group), else taken from ``w``."""
    wf = w.float()
    if absmax is None:
        absmax = wf.abs().amax(dim=1)                        # [N]
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quant_matmul_plain(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """Plain K9: x [R, K] (compute dtype) @ w_q [N, K]^T with f32
    accumulation, times scale [N] once. Returns [R, N] f32."""
    return (x.float() @ w_q.float().t()) * scale.float()


@dataclasses.dataclass(frozen=True)
class QmmPlan:
    """One K9 launch: x-row tile ``bn``, W rows a CTA ``bm``, K in ``nk``
    steps of QMM_BK cut into ``split`` splits of ``kps`` steps (the last
    may be shorter; none is empty); grid (w_tiles, x_tiles, split), the
    splits of a tile one cluster. The kernel needs no workspace: the
    splits are summed in the cluster's shared memory."""
    bn: int
    bm: int
    w_tiles: int
    x_tiles: int
    nk: int
    split: int
    kps: int

    @property
    def ctas(self) -> int:
        return self.w_tiles * self.x_tiles * self.split


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_quant_matmul(R: int, K: int, N: int, sms: int = H100_SMS) -> QmmPlan:
    """The K9 launch plan for x [R, K] @ W [N, K]^T.

    Up to QMM_SMALL_R rows one x tile holds them all (n = 56, or 64), and
    the weight stream bounds the call. Each CTA's four warpgroups take the
    K steps of 64 W rows in four ways; K is split further across a cluster
    of CTAs only while every way keeps QMM_MIN_WAY_STEPS steps (the
    planner's cap for the shape: on the card a shorter split costs more in
    the cluster's reduction than it saves), and up to the split that puts
    a CTA on each of ``sms`` SMs. Above QMM_SMALL_R rows the x-row tile is
    the compiled width that pads R least (ties to the wider), with no
    split: 1064 rows are 8 tiles of 136, 1456 are 7 of 208, 14336 are 56
    of 256."""
    nk = _cdiv(K, QMM_BK)
    if R <= QMM_SMALL_R:
        bn, bm = min(t for t in QMM_TILES if t[0] >= R)
    else:
        bn, bm = min((t for t in QMM_TILES if t[0] > QMM_SMALL_R),
                     key=lambda t: (_cdiv(R, t[0]) * t[0], -t[0]))
    w_tiles, x_tiles = _cdiv(N, bm), _cdiv(R, bn)
    split, kps = 1, nk
    cap = split_cap(R, K)
    for target in range(min(_cdiv(sms, w_tiles * x_tiles), cap), cap + 1):
        kps = _cdiv(nk, target)
        split = _cdiv(nk, kps)
        if split * w_tiles * x_tiles >= sms:
            break
    return QmmPlan(bn=bn, bm=bm, w_tiles=w_tiles, x_tiles=x_tiles, nk=nk,
                   split=split, kps=kps)


def split_cap(R: int, K: int) -> int:
    """The most K splits the planner gives a tile of R rows: 1 above
    QMM_SMALL_R rows, else as many as keep QMM_MIN_WAY_STEPS steps in each
    of the QMM_WAYS ways, at most QMM_SPLIT_CAP."""
    if R > QMM_SMALL_R:
        return 1
    steps = _cdiv(K, QMM_BK) // (QMM_WAYS * QMM_MIN_WAY_STEPS)
    return max(1, min(QMM_SPLIT_CAP, steps))


def plan_code(plan: QmmPlan) -> int:
    """The plan as the C entry point takes it, one integer: bn | bm << 9 |
    split << 18 | kps << 22."""
    return plan.bn | plan.bm << 9 | plan.split << 18 | plan.kps << 22


# plan codes by (R, K, N), filled on first use (a dict lookup a call)
_PLAN_CODES: Dict[Tuple[int, int, int], int] = {}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("quant_matmul")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bdm_quant_matmul.argtypes = [P] * 4 + [I] * 3 + [
        ctypes.c_longlong, I, P]
    lib.bdm_quant_matmul.restype = I
    lib.bdm_qmm_error_string.argtypes = [I]
    lib.bdm_qmm_error_string.restype = ctypes.c_char_p
    lib.bdm_qmm_k_align.restype = I
    if lib.bdm_qmm_k_align() != KERNEL_K_ALIGN:
        raise RuntimeError(f"bdm_qmm_k_align() = {lib.bdm_qmm_k_align()}, "
                           f"the wrapper expects {KERNEL_K_ALIGN}")
    return lib


def quant_matmul(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """K9: ``x @ (w_q * scale[:, None])^T`` with the dequant fused into the
    kernel. x [R, K] bf16 on the card (any float dtype on the CPU), w_q
    [N, K] int8, scale [N] f32 -> [R, N] f32."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_q, scale)
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"x must be [R, K], got {tuple(x.shape)}")
    R, K = x.shape
    N = w_q.shape[0]
    if K % KERNEL_K_ALIGN or R < 1:
        raise ValueError(f"the K9 kernel takes K a multiple of "
                         f"{KERNEL_K_ALIGN} and R >= 1, got R {R}, K {K}")
    check_operand("x", x, (R, K), torch.bfloat16, dev)
    check_operand("w_q", w_q, (N, K), torch.int8, dev)
    check_operand("scale", scale, (N,), torch.float32, dev)
    y = torch.empty(R, N, device=dev, dtype=torch.float32)
    code = _PLAN_CODES.get((R, K, N))
    if code is None:
        code = _PLAN_CODES[R, K, N] = plan_code(plan_quant_matmul(R, K, N))
    index = dev.index or 0
    rc = _lib().bdm_quant_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), R, K,
        N, code, index, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        msg = _lib().bdm_qmm_error_string(rc).decode()
        raise RuntimeError(f"quant_matmul launch failed: {msg} ({rc})")
    LAUNCHES["quant_matmul"] += 1
    ROW_LAUNCHES[R] = ROW_LAUNCHES.get(R, 0) + 1
    return y


# ---- W8A8 (XLA in the JAX package) ----------------------------------------

def quantize_rows(x: Tensor, amax_reduce: Optional[Callable] = None
                  ) -> Tuple[Tensor, Tensor]:
    """Per-row symmetric int8 quantization of activations [R, K]:
    (x_int8, scale [R, 1] f32); an all-zero row gets scale 1.0.
    ``amax_reduce`` maps the rows' local maxima to the whole rows' (x a
    row-parallel product's slice of K: the max over the model group)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    xs = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs


def int8_matmul(xq: Tensor, w_q: Tensor) -> Tensor:
    """Exact int32 xq [R, K] @ w_q [N, K]^T: on the card through
    :func:`int_mm_padded`, on the CPU an int64 product (exact) cast to
    int32 (|acc| <= K * 127^2 fits)."""
    if xq.device.type == "cpu":
        return (xq.long() @ w_q.long().t()).int()
    return int_mm_padded(xq, w_q)


def int_mm_padded(xq: Tensor, w_q: Tensor) -> Tensor:
    """``torch._int_mm(xq, w_q^T)``, which takes more than 16 rows and K, N
    multiples of 8: R is padded with zero rows to a multiple of 8 above 16,
    and the pad rows are cut off the result."""
    R, K = xq.shape
    N = w_q.shape[0]
    if K % 8 or N % 8:
        raise ValueError(f"torch._int_mm takes K and N multiples of 8, got "
                         f"K {K}, N {N}")
    rp = max(24, -(-R // 8) * 8)
    if rp != R:
        xq = F.pad(xq, (0, 0, 0, rp - R))
    return torch._int_mm(xq.contiguous(), w_q.t())[:R]


def w8a8_matmul(x: Tensor, w_q: Tensor, scale: Tensor,
                amax_reduce: Optional[Callable] = None) -> Tensor:
    """``x @ (w_q * scale)^T`` with the activations quantized per row too:
    int8 x int8 -> int32, then the row x column scale epilogue. [R, N]
    f32. ``amax_reduce`` as in :func:`quantize_rows`."""
    xq, xs = quantize_rows(x, amax_reduce)
    return int8_matmul(xq, w_q).float() * xs * scale[None, :].float()
