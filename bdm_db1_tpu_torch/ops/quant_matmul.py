"""int8 trunk weights: per-output-channel quantization, the CUDA kernel K9
(``quant_matmul``, y = x @ dequant(W)^T with the dequant inside the
kernel) with its plain PyTorch version, and the W8A8 product.

Counterpart of bdm_db1_tpu/ops/quant_matmul.py. Weights are in the torch
[N, K] (out, in) layout, so the JAX [K, N] kernel's int8 values and scales
are these transposed. ``quant_matmul`` takes a CPU tensor's route through
its plain version and a CUDA tensor's through csrc/quant_matmul.cu (built at
first use) or raises; ``LAUNCHES`` counts its launches. ``w8a8_matmul`` is
XLA in the JAX package, not a Pallas kernel: on the card its int8 x int8 ->
int32 product is ``torch._int_mm``, on the CPU an exact integer product.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from bdm_db1_tpu_torch.ops.cuda_build import check_operand, load_library

Tensor = torch.Tensor
KERNEL_K_ALIGN = 32     # K must be a multiple of this (checked on load)

LAUNCHES = {"quant_matmul": 0}


def quantize_weight(w: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric per-output-channel int8 quantization of a [N, K] weight:
    (w_int8 [N, K], scale [N] f32) with w ~= w_int8 * scale[:, None]. A zero
    row gets scale 1.0."""
    wf = w.float()
    absmax = wf.abs().amax(dim=1)                            # [N]
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quant_matmul_plain(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """Plain K9: x [R, K] (compute dtype) @ w_q [N, K]^T with f32
    accumulation, times scale [N] once. Returns [R, N] f32."""
    return (x.float() @ w_q.float().t()) * scale.float()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("quant_matmul")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bdm_quant_matmul.argtypes = [P] * 4 + [I] * 4 + [P]
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
    rc = _lib().bdm_quant_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), R, K,
        N, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        msg = _lib().bdm_qmm_error_string(rc).decode()
        raise RuntimeError(f"quant_matmul launch failed: {msg} ({rc})")
    LAUNCHES["quant_matmul"] += 1
    return y


# ---- W8A8 (XLA in the JAX package) ----------------------------------------

def quantize_rows(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-row symmetric int8 quantization of activations [R, K]:
    (x_int8, scale [R, 1] f32); an all-zero row gets scale 1.0."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
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


def w8a8_matmul(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """``x @ (w_q * scale)^T`` with the activations quantized per row too:
    int8 x int8 -> int32, then the row x column scale epilogue. [R, N]
    f32."""
    xq, xs = quantize_rows(x)
    return int8_matmul(xq, w_q).float() * xs * scale[None, :].float()
